"""Sparse operations, their engines, and the CUDA kernels' wrappers."""
