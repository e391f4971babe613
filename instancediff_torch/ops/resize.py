"""Resizing of NHWC batches (port of ``resize_like`` and
``downsample_label`` in ``instancediff_tpu/ops/resize.py``), at every method
``jax.image.resize`` takes, and the separable weights of its
scale-and-translate resize, which the towers' position tables use too
(``models/pos_embed.py``).

``jax.image.resize`` weights the input with a kernel centred on each output
pixel's source position (half-pixel centres), widened by the factor when it
downsamples (antialiasing), each output's weights renormalised to sum 1
where the kernel leaves the image. Its ``bilinear`` is torch's
``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``,
upsampling and downsampling, at any factor. Its ``cubic`` is Keys' kernel
with a = -0.5, where torch's ``bicubic`` uses a = -0.75, and torch has no
Lanczos: those take ``resize_weights`` along each axis. Its ``nearest``
takes the input at ``floor((i + 0.5) * in / out)`` in float32, where torch's
``mode="nearest"`` floors ``i * in / out``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_f32 = np.float32


def triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(_f32(0.0), _f32(1.0) - x)


def keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def lanczos_kernel(radius: float):
    """The Lanczos kernel of ``radius`` (1 within 1e-3 of 0, 0 beyond the
    radius), in JAX's float32 order of operations."""
    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1)
        return np.where(x > radius, 0.0, out)
    return kernel


# ``jax.image.ResizeMethod.from_string``: each name and its method
METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
           "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
           "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
           "lanczos5": "lanczos5"}
KERNELS = {"linear": triangle_kernel, "cubic": keys_cubic_kernel,
           "lanczos3": lanczos_kernel(3.0), "lanczos5": lanczos_kernel(5.0)}


def resize_method(name: str) -> str:
    """The method a ``jax.image.resize`` name selects; an unknown name raises
    ``ValueError``, as JAX's does."""
    if name not in METHODS:
        raise ValueError(f'Unknown resize method "{name}"')
    return METHODS[name]


def resize_weights(n_in: int, n_out: int, method: str, antialias: bool = True) -> np.ndarray:
    """[n_in, n_out] float32 weights of JAX's resize along one axis with the
    kernel of ``method`` (``jax._src.image.scale.compute_weight_mat``, its
    float32 math): samples at half-pixel centres, the kernel widened by the
    scale when downsampling with ``antialias``, each output's weights
    normalised to sum 1, zero for a sample outside the input."""
    kernel = KERNELS[resize_method(method)]
    inv_scale = _f32(1.0 / (n_out / n_in))  # JAX's Python-float scale, then float32
    kernel_scale = max(inv_scale, _f32(1.0)) if antialias else _f32(1.0)
    sample = (np.arange(n_out, dtype=_f32) + _f32(0.5)) * inv_scale - _f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=_f32)[:, None]) / kernel_scale
    w = kernel(x).astype(_f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(_f32)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """The input index of each output along one axis of JAX's ``nearest``:
    ``floor((i + 0.5) * n_in / n_out)`` in float32."""
    return np.floor((np.arange(n_out, dtype=_f32) + _f32(0.5)) * _f32(n_in)
                    / _f32(n_out)).astype(np.int64)


def resize_like(x: torch.Tensor, h: int, w: int, method: str = "bilinear") -> torch.Tensor:
    """An NHWC batch [B,H,W,C] resized to [B,h,w,C] by ``jax.image.resize``'s
    ``method`` (its names: ``nearest``; ``linear``/``bilinear``/``trilinear``/
    ``triangle``; ``cubic``/``bicubic``/``tricubic``; ``lanczos3``;
    ``lanczos5``), antialiased when downsampling. An axis whose size does
    not change is left as it is, as in JAX. The weighted methods compute in
    ``x``'s dtype with weights rounded to it, as JAX's do; so does a 16-bit
    ``linear`` (torch's antialiased bilinear takes no bfloat16 on the
    CPU)."""
    kind = resize_method(method)
    _, H, W, _ = x.shape
    if kind == "linear" and x.dtype in (torch.float32, torch.float64):
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1)
    for axis, n_in, n_out in ((1, H, h), (2, W, w)):
        if n_in == n_out:
            continue
        if kind == "nearest":
            x = x.index_select(axis, torch.from_numpy(nearest_indices(n_in, n_out))
                               .to(x.device))
            continue
        wm = torch.from_numpy(resize_weights(n_in, n_out, kind)).to(x.device, x.dtype)
        x = torch.tensordot(x, wm, dims=([axis], [0])).movedim(-1, axis)
    return x


def downsample_label(label: torch.Tensor, mult: int) -> torch.Tensor:
    """An NHWC label [B,H,W,C] downsampled by the integer factor ``mult`` to
    [B, H//mult, W//mult, C] (antialiased bilinear)."""
    if mult == 1:
        return label
    return resize_like(label, label.shape[1] // mult, label.shape[2] // mult)
