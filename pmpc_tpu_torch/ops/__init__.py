"""Batched linear-algebra primitives and the hand-written CUDA kernels."""
