"""Compute ops: plain attention, and the two hand-written CUDA kernels of the
sampler path with their plain PyTorch versions."""
