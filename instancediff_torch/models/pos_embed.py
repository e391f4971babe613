"""Position tables of the towers (port of ``instancediff_tpu/models/pos_embed.py``):
the fixed 2-D sin-cos table of a ViT, the resampling of a ViT's position
grid to another resolution, and the 1-D linear resampling of a text
position table.

``interpolate_pos_embed`` is JAX's ``jax.image.resize(method="cubic")``
written out: separable Keys-cubic weights (a = -0.5) at half-pixel
centres, the kernel widened by the scale when downsampling (JAX's default
antialiasing), each output's weights normalised to sum 1. torch's
``F.interpolate(mode="bicubic")`` uses a = -0.75 and does not antialias, so
it would give other values."""

from __future__ import annotations

import numpy as np
import torch


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim]: sines then cosines."""
    assert embed_dim % 2 == 0, "sin-cos embedding needs an even dim"
    omega = 1.0 / 10000.0 ** (np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[grid*grid (+1), embed_dim] float32: the first half of the channels
    encodes the W coordinate, the second half the H coordinate (the
    upstream MAE table's order); the optional class row is zeros."""
    assert embed_dim % 4 == 0, "2D sin-cos needs embed_dim % 4 == 0"
    gy, gx = np.meshgrid(np.arange(grid_size, dtype=np.float64),
                         np.arange(grid_size, dtype=np.float64), indexing="ij")
    emb = np.concatenate([_sincos_1d(embed_dim // 2, gx), _sincos_1d(embed_dim // 2, gy)],
                         axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of JAX's antialiased cubic resize along
    one axis (``jax._src.image.scale.compute_weight_mat``, float32 math)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # JAX's Python-float scale, then float32
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def interpolate_pos_embed(pos, target_len: int, n_prefix: int = 1) -> torch.Tensor:
    """Resample a [n_prefix + g*g, D] position table to [n_prefix + g'*g',
    D]: the prefix (class) rows kept, the square grid rows resized by JAX's
    cubic resize. Takes a tensor or an array; returns a float32 tensor."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    n_old, n_new = pos.shape[0] - n_prefix, target_len - n_prefix
    if n_old == n_new:
        return pos
    g_old, g_new = int(round(float(np.sqrt(n_old)))), int(round(float(np.sqrt(n_new))))
    if g_old * g_old != n_old or g_new * g_new != n_new:
        raise ValueError(f"non-square position grids: {n_old} -> {n_new} tokens")
    w = torch.from_numpy(cubic_resize_weights(g_old, g_new)).to(pos.device)
    grid = pos[n_prefix:].reshape(g_old, g_old, -1)
    grid = torch.einsum("hwd,hy,wx->yxd", grid.double(), w.double(), w.double()).float()
    return torch.cat([pos[:n_prefix], grid.reshape(g_new * g_new, -1)], dim=0)


def resize_text_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """Resample a text position table [L, D] to [target_len, D] by 1-D linear
    interpolation at half-pixel centres (``F.interpolate(mode='linear',
    align_corners=False)`` without antialiasing); equal lengths are a no-op."""
    if pos.dim() != 2:
        raise ValueError(f"text pos table must be [L, D], got {tuple(pos.shape)}")
    L, target_len = pos.shape[0], int(target_len)
    if L == target_len:
        return pos
    x = (torch.arange(target_len, dtype=torch.float32) + 0.5) * (L / target_len) - 0.5
    x = torch.clamp(x, 0.0, L - 1)
    lo = torch.floor(x).to(torch.int64)
    hi = torch.clamp(lo + 1, max=L - 1)
    w = (x - lo)[:, None].to(pos.dtype)
    return pos[lo] * (1 - w) + pos[hi] * w
