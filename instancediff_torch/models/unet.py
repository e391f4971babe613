"""The dual-conditioned UNet with per-scale score maps (port of the unpacked,
fused path of ``LearnableForwardUNetMultiScoreMap`` in
``instancediff_tpu/models/unet.py``).

Every ResBlock runs the fused body: one GroupNorm statistics pass in plain
PyTorch, then the fused GN-affine + SiLU + 3x3 conv kernel twice, with the
timestep projection folded into the first conv's bias and the one-token
cross-attention shortcut plus the residual into the second conv's epilogue.
The bottleneck self-attention runs the flash-attention kernel. The plain
convolutions around them (``conv_in``, ``down_*``, ``up_*``, the 1x1 skips
and ``smm_fuse_*``) are ``F.conv2d``/``F.conv_transpose2d``. Layout is NHWC
throughout, as in the JAX package."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..ops.fused_gn_conv import fused_gn_silu_conv3x3, gn_channel_affine
from .layers import ConvParams, GNParams, conv1x1, conv_same, conv_transpose_same, dense
from .scoremap import ScoreMapModule

_FLAX_GN_EPS = 1e-6  # flax nn.GroupNorm default, used by SelfAttention2D


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, [B] -> [B, dim] float32, order [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def gn_groups(c: int) -> int:
    """Largest group count <= 32 that divides the channel count."""
    g = min(32, c)
    while c % g:
        g -= 1
    return g


class XAttnBias(nn.Module):
    """The one-token cross-attention shortcut: softmax over a single key is
    1, so attention equals V and the branch is a per-(B,C) bias
    ``out(v(context))``."""

    def __init__(self, context_dim: int, channels: int):
        super().__init__()
        self.v = nn.Linear(context_dim, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, context):  # [B, 1, ctx] -> [B, C]
        return dense(self.out, dense(self.v, context))[:, 0]


class ResBlock(nn.Module):
    """GN + SiLU + 3x3 conv twice, timestep injection and the image-context
    shortcut, on the fused kernel."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, use_context: bool,
                 context_dim: int):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.gns1 = GNParams(in_ch)
        self.conv1 = ConvParams(in_ch, out_ch)
        self.temb_proj = nn.Linear(temb_dim, out_ch)
        self.gns2 = GNParams(out_ch)
        self.conv2 = ConvParams(out_ch, out_ch)
        self.skip = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.xattn = XAttnBias(context_dim, out_ch) if use_context else None

    def forward(self, h, temb, context=None):
        if context is not None and context.shape[1] != 1:
            raise NotImplementedError(
                "ResBlock: only one context token is supported (the one-token "
                f"cross-attention shortcut); got {context.shape[1]}")
        B = h.shape[0]
        tb = dense(self.temb_proj, F.silu(temb))  # [B, out_ch]
        scale1, shift1 = gn_channel_affine(h, self.gns1.weight, self.gns1.bias,
                                           gn_groups(self.in_ch))
        bias1 = self.conv1.bias.float()[None] + tb.float()
        y1 = fused_gn_silu_conv3x3(h, scale1, shift1, self.conv1.weight, bias1)

        scale2, shift2 = gn_channel_affine(y1, self.gns2.weight, self.gns2.bias,
                                           gn_groups(self.out_ch))
        res = h if self.skip is None else conv1x1(h, self.skip)
        bias2 = self.conv2.bias.float()[None].expand(B, self.out_ch)
        if self.xattn is not None and context is not None:
            bias2 = bias2 + self.xattn(context).float()
        return fused_gn_silu_conv3x3(y1, scale2, shift2, self.conv2.weight, bias2,
                                     residual=res)


class SelfAttention2D(nn.Module):
    """Bottleneck spatial self-attention on the flash-attention kernel."""

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(gn_groups(channels), channels, eps=_FLAX_GN_EPS)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, h):
        B, H, W, C = h.shape
        x = F.group_norm(h.float().permute(0, 3, 1, 2), self.norm.num_groups,
                         self.norm.weight, self.norm.bias, self.norm.eps)
        x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        Dh = C // self.heads

        def split(z):
            return z.reshape(B, H * W, self.heads, Dh).transpose(1, 2)

        attn = flash_attention(split(dense(self.q, x)), split(dense(self.k, x)),
                               split(dense(self.v, x)))
        attn = attn.transpose(1, 2).reshape(B, H * W, C)
        return h + dense(self.out, attn).reshape(B, H, W, C)


class LearnableForwardUNetMultiScoreMap(nn.Module):
    """``forward(x_a, x_b, t, type_idx, text_embs, image_context) ->
    (pred [B,H,W,1], score maps at H/1, H/2, ...)``. ``text_embs`` holds the
    per-scale [K, context_dim] text encodings, computed once per sampler call
    by the engine; ``num_prompts`` is their K (the score maps' width)."""

    def __init__(self, in_nc: int = 2, out_nc: int = 5, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), context_dim: int = 512,
                 text_module: str = "scoremap", score_map_chan: int = 16,
                 if_MultiScoreMap: bool = True,
                 score_map_ch_mult: Sequence[int] = (1, 1, 2, 4),
                 score_map_ngf: int = 64, use_image_context: bool = False,
                 use_degra_context: bool = False, token_embed_dim: int = 512,
                 num_res_blocks: int = 2, num_prompts: int = 5):
        super().__init__()
        if text_module != "scoremap":
            raise NotImplementedError(f"text_module {text_module!r} is not ported "
                                      "(only 'scoremap')")
        if use_degra_context:
            raise NotImplementedError("use_degra_context (two context tokens) is "
                                      "not ported")
        if not if_MultiScoreMap:
            raise NotImplementedError("the single-score-map UNet (if_MultiScoreMap="
                                      "False) is not ported")
        self.in_nc, self.out_nc, self.nf = in_nc, out_nc, nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.use_image_context = use_image_context
        n_levels = len(self.ch_mult)
        temb_dim = nf * 4

        def block(cin, cout):
            return ResBlock(cin, cout, temb_dim, use_image_context, context_dim)

        self.temb_dense0 = nn.Linear(nf, temb_dim)
        self.temb_dense1 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = nn.Conv2d(in_nc, nf, 3)
        ch = nf
        for i, mult in enumerate(self.ch_mult):
            for j in range(num_res_blocks):
                self.add_module(f"enc_{i}_{j}", block(ch, nf * mult))
                ch = nf * mult
            if i < n_levels - 1:
                self.add_module(f"down_{i}", nn.Conv2d(ch, ch, 3))
        self.mid1 = block(ch, ch)
        self.mid_attn = SelfAttention2D(ch)
        self.mid2 = block(ch, ch)

        for i in range(n_levels):
            self.add_module(f"smm_{i}", ScoreMapModule(
                in_ch=nf * self.ch_mult[i], visual_dim=score_map_ngf * score_map_ch_mult[i],
                token_embed_dim=token_embed_dim, embed_dim=context_dim))
            self.add_module(f"smm_fuse_{i}", nn.Conv2d(num_prompts, score_map_chan, 1))

        for i in reversed(range(n_levels)):
            width = nf * self.ch_mult[i]
            for j in range(num_res_blocks + 1):
                cin = ch + width + score_map_chan if j == 0 else width
                self.add_module(f"dec_{i}_{j}", block(cin, width))
                ch = width
            if i > 0:
                up_ch = nf * self.ch_mult[i - 1]
                self.add_module(f"up_{i - 1}", nn.ConvTranspose2d(ch, up_ch, 4))
                ch = up_ch
        self.norm_out = GNParams(nf)
        self.conv_out = ConvParams(nf, out_nc)

    def smm_contexts(self):
        """Each SMM's learnable context tokens, for the text tower."""
        return [getattr(self, f"smm_{i}").context for i in range(len(self.ch_mult))]

    def forward(self, x_a, x_b, t, type_idx, text_embs: Sequence[torch.Tensor],
                image_context: Optional[torch.Tensor] = None):
        dtype = self.conv_in.weight.dtype
        B = x_a.shape[0]
        n_levels = len(self.ch_mult)
        x = torch.cat([x_a, x_b], dim=-1)
        temb = timestep_embedding(t, self.nf).to(dtype)
        temb = dense(self.temb_dense1, F.silu(dense(self.temb_dense0, temb)))
        context = None
        if self.use_image_context and image_context is not None:
            context = image_context.to(dtype)  # [B, 1, context_dim]
        gather_idx = type_idx.long().reshape(B, 1, 1, 1)

        h = conv_same(x, self.conv_in)
        skips = []
        for i in range(n_levels):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"enc_{i}_{j}")(h, temb, context)
            skips.append(h)
            if i < n_levels - 1:
                h = conv_same(h, getattr(self, f"down_{i}"), stride=2)

        h = self.mid1(h, temb, context)
        h = self.mid_attn(h)
        h = self.mid2(h, temb, context)

        scoremaps = [None] * n_levels
        for i in reversed(range(n_levels)):
            skip = skips[i]
            maps = getattr(self, f"smm_{i}")(skip, text_embs[i])  # [B,h,w,K]
            scoremaps[i] = torch.gather(maps, -1, gather_idx.expand(*maps.shape[:3], 1))
            fused = conv1x1(maps, getattr(self, f"smm_fuse_{i}"))
            h = torch.cat([h, skip, fused.to(skip.dtype)], dim=-1)
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f"dec_{i}_{j}")(h, temb, context)
            if i > 0:
                h = conv_transpose_same(h, getattr(self, f"up_{i - 1}"))

        scale, shift = gn_channel_affine(h, self.norm_out.weight, self.norm_out.bias,
                                         gn_groups(self.nf))
        bias = self.conv_out.bias.float()[None].expand(B, self.out_nc)
        out = fused_gn_silu_conv3x3(h, scale, shift, self.conv_out.weight, bias)
        if self.out_nc > 1:
            pred = torch.gather(out, -1, gather_idx.expand(*out.shape[:3], 1))
        else:
            pred = out
        return pred, scoremaps
