"""Position tables of the towers (port of ``instancediff_tpu/models/pos_embed.py``):
the fixed 2-D sin-cos table of a ViT, the resampling of a ViT's position
grid to another resolution (cubic, and the bilinear one the RN attention
pool's and the dense ViT's loaders use, ``resample_grid_rows``), and the
1-D linear resampling of a text position table.

``interpolate_pos_embed`` is JAX's ``jax.image.resize(method="cubic")``
written out: separable Keys-cubic weights (a = -0.5, ``ops/resize.py:
resize_weights``) at half-pixel centres, the kernel widened by the scale
when downsampling (JAX's default antialiasing), each output's weights
normalised to sum 1. torch's ``F.interpolate(mode="bicubic")`` uses a =
-0.75 and does not antialias, so it would give other values."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_weights


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


def resample_grid_rows(pos, n_new: int) -> torch.Tensor:
    """A [1 + g*g, D] position table (class row first) with its grid rows
    resized bilinearly to g'*g' = ``n_new`` (``resize_weights`` without
    antialiasing on both axes, the loaders' ``jax.image.resize(...,
    "bilinear", antialias=False)``; an edge sample takes the edge row, as
    ``F.interpolate(align_corners=False)`` clamps it); a float32 tensor, the
    table as it is when the grid does not change."""
    pos = torch.as_tensor(np.asarray(pos, dtype=np.float32))
    n_old = pos.shape[0] - 1
    if n_old == n_new:
        return pos
    g_old, g_new = int(round(float(np.sqrt(n_old)))), int(round(float(np.sqrt(n_new))))
    if g_old * g_old != n_old or g_new * g_new != n_new:
        raise ValueError(f"non-square position grids: {n_old} -> {n_new} tokens")
    w = torch.from_numpy(resize_weights(g_old, g_new, "linear", antialias=False)).double()
    grid = pos[1:].reshape(g_old, g_old, -1).double()
    grid = torch.einsum("hwd,hy,wx->yxd", grid, w, w).float()
    return torch.cat([pos[:1], grid.reshape(g_new * g_new, -1)], dim=0)


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
    w = torch.from_numpy(resize_weights(g_old, g_new, "cubic")).to(pos.device)
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
