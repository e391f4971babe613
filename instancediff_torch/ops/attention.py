"""Attention compute core (port of ``instancediff_tpu/ops/attention.py``).

Plain matmuls outside any kernel, as the JAX package leaves them to XLA.
Logits and softmax run in float32 whatever the input dtype. Also the
training-time stochastic depth ``drop_path`` and ``draw``, which gives a
random draw from a ``torch.Generator`` or takes it from an iterator of draws
made elsewhere (JAX's, in the parity tests: torch cannot replay threefry)."""

from __future__ import annotations

import numpy as np
import torch


def draw(rng, shape, dtype, device, normal: bool = False) -> torch.Tensor:
    """A draw of ``shape``: uniform on [0, 1) (or standard normal) from
    ``rng`` when it is a ``torch.Generator``; else ``rng`` is an iterator of
    the draws themselves, in the order the modules ask for them, and the
    next one is taken (its shape must be ``shape``)."""
    if rng is None:
        raise ValueError("a training-mode draw needs rng: a torch.Generator or an iterator "
                         "of draws")
    if isinstance(rng, torch.Generator):
        fn = torch.randn if normal else torch.rand
        return fn(tuple(shape), generator=rng, dtype=dtype, device=device)
    value = next(rng)
    value = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    if tuple(value.shape) != tuple(shape):
        raise ValueError(f"draw of shape {tuple(value.shape)} where {tuple(shape)} is needed")
    return value.to(device=device, dtype=dtype)


def drop_path(x, rate: float, rng=None):
    """Per-sample stochastic depth on a residual branch (timm's
    ``drop_path``): the branch of each sample is zeroed where ``floor(keep +
    u)`` is 0, for ``u`` uniform in x's dtype (``draw``), and the rest is
    scaled by 1/keep, keep = 1 - ``rate``. Identity at ``rate`` <= 0."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.floor(keep + draw(rng, shape, x.dtype, x.device))
    return x / keep * mask


def dot_product_attention(q, k, v, mask=None, scale=None):
    """q: [..., Lq, D], k/v: [..., Lk, D]; additive ``mask`` broadcastable to
    [..., Lq, Lk]. Products of bf16 inputs are exact in float32, so upcasting
    before the QK product equals JAX's ``preferred_element_type=float32``."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, v)


def clamp_qkv(q, k, v, qkv_clamp=None):
    """q, k and v bounded to +-``qkv_clamp`` (the low-precision overflow
    guard of the reference's fp16 attention, clamp 255); as they are when
    None."""
    if qkv_clamp is None:
        return q, k, v
    return tuple(t.clamp(-qkv_clamp, qkv_clamp) for t in (q, k, v))


def multi_head_attention(q, k, v, num_heads, mask=None, qkv_clamp=None):
    """Split-head attention over the last dim. q: [B, Lq, C], k/v: [B, Lk, C]
    -> [B, Lq, C]. A 3-D ``mask`` broadcasts over heads; ``qkv_clamp``
    bounds q/k/v first (``clamp_qkv``)."""
    q, k, v = clamp_qkv(q, k, v, qkv_clamp)
    B, Lq, C = q.shape
    Lk = k.shape[1]
    Dh = C // num_heads

    def split(x, L):
        return x.reshape(B, L, num_heads, Dh).transpose(1, 2)

    if mask is not None and mask.dim() == 3:
        mask = mask[:, None]
    out = dot_product_attention(split(q, Lq), split(k, Lk), split(v, Lk), mask=mask)
    return out.transpose(1, 2).reshape(B, Lq, C)
