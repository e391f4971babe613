"""Score Map Module (port of ``ScaledDecoderLayer`` and the unpacked
``ScoreMapModule.__call__`` in ``instancediff_tpu/models/scoremap.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from .layers import dense, layer_norm

_FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm default (torch's is 1e-5)


class ScaledDecoderLayer(nn.Module):
    """Cross-attention + MLP decoder layer with learned branch scales."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: float = 4.0):
        super().__init__()
        self.heads = heads
        self.gamma1 = nn.Parameter(torch.full((dim,), 0.1))
        self.gamma2 = nn.Parameter(torch.full((dim,), 0.1))
        self.ln_q = nn.LayerNorm(dim, eps=_FLAX_LN_EPS)
        self.ln_m = nn.LayerNorm(dim, eps=_FLAX_LN_EPS)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ln_mlp = nn.LayerNorm(dim, eps=_FLAX_LN_EPS)
        self.fc = nn.Linear(dim, int(dim * mlp_ratio))
        self.proj = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, q, memory):
        h = layer_norm(self.ln_q, q)
        m = layer_norm(self.ln_m, memory)
        attn = multi_head_attention(dense(self.q_proj, h), dense(self.k_proj, m),
                                    dense(self.v_proj, m), self.heads)
        q = q + self.gamma1.to(q.dtype) * dense(self.out_proj, attn)
        h = dense(self.fc, layer_norm(self.ln_mlp, q))
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
        return q + self.gamma2.to(q.dtype) * dense(self.proj, h)


class ScoreMapModule(nn.Module):
    """``forward(vis [B,h,w,C], text_emb [K,E]) -> score maps [B,h,w,K]``.
    The decoder reads the features average-pooled to at most 16x16 tokens;
    the score head projects the refined queries down to visual space. With
    ``sp`` (a ``parallel.spatial.SpatialGroup``) vis is this rank's rows:
    the pooled memory (or, at levels of at most 16 rows, vis itself) is
    gathered from every rank, so the queries and the decoder layers are the
    same on every rank, and each rank scores its own pixels."""

    def __init__(self, in_ch: int, visual_dim: int, token_embed_dim: int = 512,
                 embed_dim: int = 512, n_ctx: int = 8, decoder_layers: int = 3,
                 heads: int = 4, max_mem_hw: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.max_mem_hw = max_mem_hw
        self.context = nn.Parameter(torch.zeros(n_ctx, token_embed_dim))
        self.vis_in = nn.Linear(in_ch, visual_dim)
        self.mem_proj = nn.Linear(visual_dim, embed_dim)
        self.decoder_layers = decoder_layers
        for i in range(decoder_layers):
            self.add_module(f"dec_{i}", ScaledDecoderLayer(embed_dim, heads))
        self.q_ln = nn.LayerNorm(embed_dim, eps=_FLAX_LN_EPS)
        self.q_to_vis = nn.Linear(embed_dim, visual_dim)
        self.logit_scale = nn.Parameter(torch.tensor(float(visual_dim) ** -0.5))
        self.score_bias = nn.Parameter(torch.tensor(0.0))

    def get_context(self) -> nn.Parameter:
        """The learnable context tokens [n_ctx, token_embed_dim] (JAX's accessor)."""
        return self.context

    def forward(self, vis, text_emb, sp=None):
        B, h, w, C = vis.shape
        K = text_emb.shape[0]
        sharded = sp is not None and sp.world > 1
        rows = h * sp.world if sharded else h  # the whole image's
        if rows > self.max_mem_hw or w > self.max_mem_hw:
            ph, pw = rows // self.max_mem_hw, w // self.max_mem_hw
            pooled = F.avg_pool2d(vis.permute(0, 3, 1, 2), (ph, pw), (ph, pw)).permute(0, 2, 3, 1)
        else:
            pooled = vis
        if sharded:
            pooled = sp.gather_h(pooled)
        mh, mw = pooled.shape[1], pooled.shape[2]
        memory = dense(self.mem_proj, dense(self.vis_in, pooled.reshape(B, mh * mw, C)))
        q = text_emb[None].expand(B, K, self.embed_dim).to(vis.dtype)
        for i in range(self.decoder_layers):
            q = getattr(self, f"dec_{i}")(q, memory)
        tokens = dense(self.vis_in, vis.reshape(B, h * w, C))  # [B, hw, V]
        q_vis = dense(self.q_to_vis, layer_norm(self.q_ln, q).to(vis.dtype))  # [B, K, V]
        score = (torch.matmul(tokens, q_vis.transpose(1, 2)) * self.logit_scale.to(vis.dtype)
                 + self.score_bias.to(vis.dtype))
        return score.reshape(B, h, w, K)
