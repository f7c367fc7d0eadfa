"""Kernels (``kernels``), the three CUDA kernels behind their autograd
Functions (``matvec``, ``kuf``), and CG with its preconditioner."""
