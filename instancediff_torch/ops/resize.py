"""Resizing of NHWC batches (port of ``resize_like`` and
``downsample_label`` in ``instancediff_tpu/ops/resize.py``).

``jax.image.resize(..., "bilinear")`` weights the input with a triangle
kernel centred on each output pixel's source position (half-pixel
centres), widened by the factor when it downsamples (antialiasing), its
weights renormalised at the borders. That is torch's
``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``,
upsampling and downsampling, at any factor."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_like(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """An NHWC batch [B,H,W,C] resized to [B,h,w,C], antialiased bilinear (the
    JAX function's default ``method``, the one ported)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def downsample_label(label: torch.Tensor, mult: int) -> torch.Tensor:
    """An NHWC label [B,H,W,C] downsampled by the integer factor ``mult`` to
    [B, H//mult, W//mult, C] (antialiased bilinear)."""
    if mult == 1:
        return label
    return resize_like(label, label.shape[1] // mult, label.shape[2] // mult)
