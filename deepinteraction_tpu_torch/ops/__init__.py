"""Tensor ops of the port; K1 and K2 are hand-written CUDA kernels."""
