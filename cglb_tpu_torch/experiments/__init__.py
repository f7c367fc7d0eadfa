"""CLI and datasets."""
