"""Frozen CLIP text tower with learnable-context splicing (port of
``TransformerBlock`` and ``CLIPTextContextEncoder`` in
``instancediff_tpu/models/text_encoder.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import multi_head_attention
from .layers import dense, layer_norm


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + out_proj(attn(ln_1(x))), x + proj(quick_gelu(fc(ln_2(x))))."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, ln_eps: float = 1e-5):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width, eps=ln_eps)
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=ln_eps)
        self.fc = nn.Linear(width, int(width * mlp_ratio))
        self.proj = nn.Linear(int(width * mlp_ratio), width)

    def forward(self, x, mask=None):
        h = layer_norm(self.ln_1, x)
        attn = multi_head_attention(dense(self.q_proj, h), dense(self.k_proj, h),
                                    dense(self.v_proj, h), self.heads, mask=mask)
        x = x + dense(self.out_proj, attn)
        h = quick_gelu(dense(self.fc, layer_norm(self.ln_2, x)))
        return x + dense(self.proj, h)


class CLIPTextContextEncoder(nn.Module):
    """``forward(ids [K, L], context [n_ctx, width] | None) -> [K, embed_dim]``.
    The sequence is [SOT, context..., tokens...] cut back to L; the EOT
    pooling index shifts by n_ctx (capped at L-1); the mask is causal."""

    def __init__(self, context_length: int = 42, vocab_size: int = 49408, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.width = width
        self.layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Linear(width, embed_dim, bias=False)

    def forward(self, ids: torch.Tensor, context: Optional[torch.Tensor] = None):
        K, L = ids.shape
        tok = self.token_embedding(ids.long())
        if context is not None:
            n_ctx = context.shape[0]
            ctx = context[None].expand(K, n_ctx, self.width).to(tok.dtype)
            x = torch.cat([tok[:, :1], ctx, tok[:, 1: L - n_ctx]], dim=1)
            eos_pos = torch.clamp(ids.argmax(dim=-1) + n_ctx, max=L - 1)
        else:
            x = tok
            eos_pos = ids.argmax(dim=-1)
        x = x + self.positional_embedding[: x.shape[1]].to(x.dtype)[None]
        causal = torch.full((L, L), float("-inf"), device=ids.device).triu(1)[None]
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, mask=causal)
        x = layer_norm(self.ln_final, x)
        pooled = x[torch.arange(K, device=ids.device), eos_pos]
        return dense(self.text_projection, pooled)


def build_text_encoder(embed_dim: int = 512, tiny: bool = False):
    """The CLIP tower at full size or the ``tiny`` test size of the JAX
    package's ``build_text_encoder``. Returns (module, token_embed_dim)."""
    if tiny:
        return CLIPTextContextEncoder(width=48, heads=4, layers=2, embed_dim=embed_dim,
                                      vocab_size=512, context_length=16), 48
    return CLIPTextContextEncoder(embed_dim=embed_dim), 512
