"""Curvature, eigensolver, spectral penalty and the CUDA kernels."""
