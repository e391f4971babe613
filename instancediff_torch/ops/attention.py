"""Attention compute core (port of ``instancediff_tpu/ops/attention.py``).

Plain matmuls outside any kernel, as the JAX package leaves them to XLA.
Logits and softmax run in float32 whatever the input dtype."""

from __future__ import annotations

import torch


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


def multi_head_attention(q, k, v, num_heads, mask=None):
    """Split-head attention over the last dim. q: [B, Lq, C], k/v: [B, Lk, C]
    -> [B, Lq, C]. A 3-D ``mask`` broadcasts over heads."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    Dh = C // num_heads

    def split(x, L):
        return x.reshape(B, L, num_heads, Dh).transpose(1, 2)

    if mask is not None and mask.dim() == 3:
        mask = mask[:, None]
    out = dot_product_attention(split(q, Lq), split(k, Lk), split(v, Lk), mask=mask)
    return out.transpose(1, 2).reshape(B, Lq, C)
