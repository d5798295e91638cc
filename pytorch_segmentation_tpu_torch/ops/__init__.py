"""Tensor ops: resizing and the hand-written kernels."""
