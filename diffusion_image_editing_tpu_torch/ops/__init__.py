"""Ops: attention (hand-written CUDA flash kernels), group norm, conv."""
