"""Training, inducing-point selection, serialization, metrics, logging."""
