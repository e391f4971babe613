"""Compute ops: plain attention, and the hand-written CUDA kernels of the
sampler paths with their plain PyTorch versions."""
