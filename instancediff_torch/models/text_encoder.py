"""Frozen CLIP text tower with learnable-context splicing (port of
``TransformerBlock``, ``CLIPTextContextEncoder`` and
``load_torch_clip_text_weights`` in ``instancediff_tpu/models/text_encoder.py``,
and of ``resize_text_pos_embed`` in ``instancediff_tpu/models/pos_embed.py``)."""

from __future__ import annotations

import os
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


def _read_state_dict(checkpoint_path_or_sd):
    if not isinstance(checkpoint_path_or_sd, (str, os.PathLike)):
        return checkpoint_path_or_sd
    if not os.path.isfile(checkpoint_path_or_sd):
        raise FileNotFoundError(checkpoint_path_or_sd)
    try:  # OpenAI's ViT-B-32.pt is a torch.jit archive
        return torch.jit.load(checkpoint_path_or_sd, map_location="cpu").float().state_dict()
    except RuntimeError:
        sd = torch.load(checkpoint_path_or_sd, map_location="cpu")
        return sd.get("state_dict", sd)


def load_torch_clip_text_weights(encoder: CLIPTextContextEncoder, checkpoint_path_or_sd,
                                 pos_embed_mode: str = "auto") -> CLIPTextContextEncoder:
    """Fill ``encoder`` in place from an OpenAI / open_clip CLIP checkpoint's
    text tower (a path to a torch.jit archive or a state dict, or the dict
    itself): ``token_embedding``, ``positional_embedding``,
    ``transformer.resblocks.*``, ``ln_final`` and ``text_projection``; keys
    the checkpoint lacks keep their values. A positional table of another
    length is cut to the tower's (``"auto"``, when longer) or linearly
    resampled (``"auto"`` when shorter, or always with ``"interpolate"``)."""
    sd = _read_state_dict(checkpoint_path_or_sd)

    def get(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    def put(param, value):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint gives shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    with torch.no_grad():
        if "token_embedding.weight" in sd:
            put(encoder.token_embedding.weight, get("token_embedding.weight"))
        if "positional_embedding" in sd:
            pos = get("positional_embedding")
            L, width = encoder.positional_embedding.shape
            if pos.shape[1] != width:
                raise ValueError("text pos_embed width changed!")
            if pos_embed_mode == "auto" and pos.shape[0] >= L:
                pos = pos[:L]
            else:
                pos = resize_text_pos_embed(pos, L)
            put(encoder.positional_embedding, pos)
        if "ln_final.weight" in sd:
            put(encoder.ln_final.weight, get("ln_final.weight"))
            put(encoder.ln_final.bias, get("ln_final.bias"))
        if "text_projection" in sd:  # pooled @ text_projection: a bias-free Linear
            put(encoder.text_projection.weight, get("text_projection").T)
        for i in range(encoder.layers):
            R = f"transformer.resblocks.{i}."
            blk = getattr(encoder, f"block_{i}")
            if R + "attn.in_proj_weight" in sd:
                w, b = get(R + "attn.in_proj_weight"), get(R + "attn.in_proj_bias")
                C = w.shape[1]  # rows q | k | v
                for j, lin in enumerate((blk.q_proj, blk.k_proj, blk.v_proj)):
                    put(lin.weight, w[j * C:(j + 1) * C])
                    put(lin.bias, b[j * C:(j + 1) * C])
            for name, lin in (("attn.out_proj", blk.out_proj), ("mlp.c_fc", blk.fc),
                              ("mlp.c_proj", blk.proj), ("ln_1", blk.ln_1),
                              ("ln_2", blk.ln_2)):
                if R + name + ".weight" in sd:
                    put(lin.weight, get(R + name + ".weight"))
                    put(lin.bias, get(R + name + ".bias"))
    return encoder
