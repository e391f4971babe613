"""Compute ops: plain attention, resizing, degradations, and the
hand-written CUDA kernels of the sampler paths with their plain PyTorch
versions (in their own modules)."""

from .attention import multi_head_attention, dot_product_attention
from .resize import resize_like, downsample_label
from .degradations import add_gaussian_noise, add_speckle, low_dose_sim, apply_degradation

__all__ = [
    "multi_head_attention",
    "dot_product_attention",
    "resize_like",
    "downsample_label",
    "add_gaussian_noise",
    "add_speckle",
    "low_dose_sim",
    "apply_degradation",
]
