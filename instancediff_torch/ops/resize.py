"""Label resizing for the score-map pyramid loss (port of
``downsample_label`` in ``instancediff_tpu/ops/resize.py``).

``jax.image.resize(..., "bilinear")`` antialiases when it downsamples: a
triangle kernel widened by the factor, its weights renormalised at the
borders. That is torch's ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def downsample_label(label: torch.Tensor, mult: int) -> torch.Tensor:
    """An NHWC label [B,H,W,C] downsampled by the integer factor ``mult`` to
    [B, H//mult, W//mult, C] (antialiased bilinear)."""
    if mult == 1:
        return label
    B, H, W, C = label.shape
    y = F.interpolate(label.permute(0, 3, 1, 2), size=(H // mult, W // mult),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)
