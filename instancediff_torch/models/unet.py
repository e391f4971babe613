"""The dual-conditioned UNet with per-scale score maps (port of the unpacked
path of ``LearnableForwardUNetMultiScoreMap`` in
``instancediff_tpu/models/unet.py``).

Each ResBlock runs one of two bodies on the same parameters. The fused body:
one GroupNorm statistics pass in plain PyTorch, then the fused GN-affine +
SiLU + 3x3 conv kernel twice, with the timestep projection folded into the
first conv's bias and the one-token cross-attention shortcut plus the
residual into the second conv's epilogue. The unfused body: the GroupNorm +
SiLU kernel, then a plain 3x3 conv, twice, then the residual and the
cross-attention (any number of context tokens). The bottleneck
self-attention runs the flash-attention kernel. The plain convolutions
(``conv_in``, ``down_*``, ``up_*``, the 1x1 skips, ``smm_fuse_*`` and the
unfused body's 3x3 convs) are ``F.conv2d``/``F.conv_transpose2d``, as they
are XLA convolutions in the JAX package. Layout is NHWC throughout, as in the
JAX package.

``forward(..., plain=True)`` is the differentiable path the JAX package trains
through (its train-time UNet is built without kernel knobs): the unfused
body with GroupNorm + SiLU in plain PyTorch (``group_norm_silu_plain``, the
numerics of ``group_norm_silu_reference``), the bottleneck attention on
``ops/attention.py`` (the jnp ``multi_head_attention``) and the unfused
head; no CUDA kernel runs, and each ResBlock is rematerialised in the
backward (``torch.utils.checkpoint``) when the net's ``remat`` is set."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_gn_conv import fused_gn_silu_conv3x3, gn_channel_affine
from ..ops.group_norm_silu import group_norm_silu, group_norm_silu_plain
from .layers import (ConvParams, compute_dtype, conv1x1, conv3x3, conv_same,
                     conv_transpose_same, dense, layer_norm)
from .scoremap import ScoreMapModule

_FLAX_GN_EPS = 1e-6  # flax nn.GroupNorm default, used by SelfAttention2D
_FLAX_LN_EPS = 1e-6  # flax nn.LayerNorm default, used by ContextCrossAttention


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


class FusedGroupNormSiLU(nn.Module):
    """GroupNorm (eps 1e-5, float32 statistics) + SiLU on the
    ``group_norm_silu`` kernel. ``weight``/``bias`` are flax's
    ``scale``/``bias``; the fused ResBlock body folds the same parameters into
    its conv's per-(B,C) scale and shift instead of calling this module."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = gn_groups(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, plain: bool = False):
        gns = group_norm_silu_plain if plain else group_norm_silu
        return gns(x, self.weight, self.bias, self.num_groups)


class ContextCrossAttention(nn.Module):
    """Cross-attention from the spatial features to the context tokens. With
    one token the softmax over a single key is 1, so attention equals V and
    the branch is the per-(B,C) bias ``out(v(context))``. ``q``, ``k`` and the
    LayerNorm exist only in a block built for more than one token, as flax
    creates them only then."""

    def __init__(self, context_dim: int, channels: int, multi_token: bool, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.v = nn.Linear(context_dim, channels)
        self.out = nn.Linear(channels, channels)
        if multi_token:
            self.ln = nn.LayerNorm(channels, eps=_FLAX_LN_EPS)
            self.q = nn.Linear(channels, channels)
            self.k = nn.Linear(context_dim, channels)

    def bias(self, context):  # [B, 1, ctx] -> [B, C]
        return dense(self.out, dense(self.v, context))[:, 0]

    def forward(self, h, context):
        if context.shape[1] == 1:
            return h + self.bias(context)[:, None, None]
        B, H, W, C = h.shape
        q = dense(self.q, layer_norm(self.ln, h.reshape(B, H * W, C)))
        attn = multi_head_attention(q, dense(self.k, context), dense(self.v, context),
                                    self.heads)
        return h + dense(self.out, attn).reshape(B, H, W, C)


class ResBlock(nn.Module):
    """GN + SiLU + 3x3 conv twice, timestep injection and the context
    cross-attention. Two bodies on one set of parameters: the fused body
    (two fused GN-affine + SiLU + conv kernels, the timestep projection and
    the one-token shortcut folded into the conv biases, the residual into the
    second conv) and the unfused body (the GN + SiLU kernel, then a cuDNN
    conv, twice). ``forward`` takes the fused body when asked to and the
    context has at most one token, as the JAX block does. ``context_tokens``
    is the number of context tokens the block is built for (0: no
    cross-attention). ``plain`` runs the unfused body on the plain GroupNorm
    (the differentiable path)."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, context_dim: int,
                 context_tokens: int):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.gns1 = FusedGroupNormSiLU(in_ch)
        self.conv1 = ConvParams(in_ch, out_ch)
        self.temb_proj = nn.Linear(temb_dim, out_ch)
        self.gns2 = FusedGroupNormSiLU(out_ch)
        self.conv2 = ConvParams(out_ch, out_ch)
        self.skip = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None
        self.xattn = (ContextCrossAttention(context_dim, out_ch, context_tokens > 1)
                      if context_tokens else None)

    def forward(self, h, temb, context=None, fused: bool = True, plain: bool = False):
        if fused and not plain and (context is None or context.shape[1] == 1):
            return self._fused_body(h, temb, context)
        return self._unfused_body(h, temb, context, plain)

    def _fused_body(self, h, temb, context):
        B = h.shape[0]
        tb = dense(self.temb_proj, F.silu(temb))  # [B, out_ch]
        scale1, shift1 = gn_channel_affine(h, self.gns1.weight, self.gns1.bias,
                                           self.gns1.num_groups)
        bias1 = self.conv1.bias.float()[None] + tb.float()
        y1 = fused_gn_silu_conv3x3(h, scale1, shift1, self.conv1.weight, bias1)

        scale2, shift2 = gn_channel_affine(y1, self.gns2.weight, self.gns2.bias,
                                           self.gns2.num_groups)
        res = h if self.skip is None else conv1x1(h, self.skip)
        bias2 = self.conv2.bias.float()[None].expand(B, self.out_ch)
        if self.xattn is not None and context is not None:
            bias2 = bias2 + self.xattn.bias(context).float()
        return fused_gn_silu_conv3x3(y1, scale2, shift2, self.conv2.weight, bias2,
                                     residual=res)

    def _unfused_body(self, h, temb, context, plain: bool = False):
        x = conv3x3(self.gns1(h, plain), self.conv1)
        x = x + dense(self.temb_proj, F.silu(temb))[:, None, None]
        x = conv3x3(self.gns2(x, plain), self.conv2)
        h = (h if self.skip is None else conv1x1(h, self.skip)) + x
        if self.xattn is not None and context is not None:
            h = self.xattn(h, context)
        return h


class SelfAttention2D(nn.Module):
    """Bottleneck spatial self-attention on the flash-attention kernel, or
    with ``plain`` on ``ops/attention.py`` (the JAX package's jnp attention,
    which it trains through)."""

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.norm = nn.GroupNorm(gn_groups(channels), channels, eps=_FLAX_GN_EPS)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)

    def forward(self, h, plain: bool = False):
        B, H, W, C = h.shape
        x = F.group_norm(h.float().permute(0, 3, 1, 2), self.norm.num_groups,
                         self.norm.weight, self.norm.bias, self.norm.eps)
        x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        if plain:
            attn = multi_head_attention(dense(self.q, x), dense(self.k, x), dense(self.v, x),
                                        self.heads)
            return h + dense(self.out, attn).reshape(B, H, W, C)
        Dh = C // self.heads

        def split(z):
            return z.reshape(B, H * W, self.heads, Dh).transpose(1, 2)

        attn = flash_attention(split(dense(self.q, x)), split(dense(self.k, x)),
                               split(dense(self.v, x)))
        attn = attn.transpose(1, 2).reshape(B, H * W, C)
        return h + dense(self.out, attn).reshape(B, H, W, C)


class LearnableForwardUNetMultiScoreMap(nn.Module):
    """``forward(x_a, x_b, t, type_idx, text_embs, image_context,
    degra_context) -> (pred [B,H,W,1], score maps)``. ``text_embs`` holds one
    [K, context_dim] text encoding per SMM, computed once per sampler call by
    the engine; ``num_prompts`` is their K (the score maps' width). With
    ``if_MultiScoreMap`` every level has an SMM and a score map; without it
    (the DDPM baseline's single-score-map UNet) only level 0 has one.
    ``use_fused_gnconv`` selects the ResBlock body and the output head (see
    ``ResBlock``); the context is [image | degradation] tokens. ``plain``
    runs the differentiable path (see the module's docstring); ``remat``
    (set by the engine that trains the net) rematerialises its ResBlocks
    there."""

    def __init__(self, in_nc: int = 2, out_nc: int = 5, nf: int = 64,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), context_dim: int = 512,
                 text_module: str = "scoremap", score_map_chan: int = 16,
                 if_MultiScoreMap: bool = True,
                 score_map_ch_mult: Sequence[int] = (1, 1, 2, 4),
                 score_map_ngf: int = 64, use_image_context: bool = False,
                 use_degra_context: bool = False, token_embed_dim: int = 512,
                 num_res_blocks: int = 2, num_prompts: int = 5,
                 use_fused_gnconv: bool = True):
        super().__init__()
        if text_module != "scoremap":
            raise NotImplementedError(f"text_module {text_module!r} is not ported "
                                      "(only 'scoremap')")
        self.in_nc, self.out_nc, self.nf = in_nc, out_nc, nf
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.if_MultiScoreMap = if_MultiScoreMap
        self.use_image_context = use_image_context
        self.use_degra_context = use_degra_context
        self.use_fused_gnconv = use_fused_gnconv
        self.remat = False
        n_levels = len(self.ch_mult)
        temb_dim = nf * 4
        context_tokens = int(use_image_context) + int(use_degra_context)

        def block(cin, cout):
            return ResBlock(cin, cout, temb_dim, context_dim, context_tokens)

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

        for i in range(self.n_smms):
            visual_dim = score_map_ngf * (score_map_ch_mult[i] if if_MultiScoreMap else 1)
            self.add_module(f"smm_{i}", ScoreMapModule(
                in_ch=nf * self.ch_mult[i], visual_dim=visual_dim,
                token_embed_dim=token_embed_dim, embed_dim=context_dim))
            self.add_module(f"smm_fuse_{i}", nn.Conv2d(num_prompts, score_map_chan, 1))

        for i in reversed(range(n_levels)):
            width = nf * self.ch_mult[i]
            for j in range(num_res_blocks + 1):
                cin = width
                if j == 0:
                    cin = ch + width + (score_map_chan if self._has_smm(i) else 0)
                self.add_module(f"dec_{i}_{j}", block(cin, width))
                ch = width
            if i > 0:
                up_ch = nf * self.ch_mult[i - 1]
                self.add_module(f"up_{i - 1}", nn.ConvTranspose2d(ch, up_ch, 4))
                ch = up_ch
        self.norm_out = FusedGroupNormSiLU(nf)
        self.conv_out = ConvParams(nf, out_nc)

    @property
    def n_smms(self) -> int:
        return len(self.ch_mult) if self.if_MultiScoreMap else 1

    def _has_smm(self, level: int) -> bool:
        return self.if_MultiScoreMap or level == 0

    def smm_contexts(self):
        """Each SMM's learnable context tokens, for the text tower."""
        return [getattr(self, f"smm_{i}").context for i in range(self.n_smms)]

    def forward(self, x_a, x_b, t, type_idx, text_embs: Sequence[torch.Tensor],
                image_context: Optional[torch.Tensor] = None,
                degra_context: Optional[torch.Tensor] = None, plain: bool = False):
        dtype = compute_dtype(self.conv_in)
        B = x_a.shape[0]
        n_levels = len(self.ch_mult)
        fused = self.use_fused_gnconv and not plain

        def resblock(name, h):
            blk = getattr(self, name)
            if plain and self.remat:
                return checkpoint(blk, h, temb, context, False, True, use_reentrant=False)
            return blk(h, temb, context, fused, plain)

        x = torch.cat([x_a, x_b], dim=-1)
        temb = timestep_embedding(t, self.nf).to(dtype)
        temb = dense(self.temb_dense1, F.silu(dense(self.temb_dense0, temb)))
        context = None
        if self.use_image_context and image_context is not None:
            context = image_context.to(dtype)  # [B, 1, context_dim]
        if self.use_degra_context and degra_context is not None:
            d = degra_context.to(dtype)
            context = d if context is None else torch.cat([context, d], dim=1)
        gather_idx = type_idx.long().reshape(B, 1, 1, 1)

        h = conv_same(x, self.conv_in)
        skips = []
        for i in range(n_levels):
            for j in range(self.num_res_blocks):
                h = resblock(f"enc_{i}_{j}", h)
            skips.append(h)
            if i < n_levels - 1:
                h = conv_same(h, getattr(self, f"down_{i}"), stride=2)

        h = resblock("mid1", h)
        h = self.mid_attn(h, plain)
        h = resblock("mid2", h)

        scoremaps = []
        for i in reversed(range(n_levels)):
            parts = [h, skips[i]]
            if self._has_smm(i):
                smm_i = i if self.if_MultiScoreMap else 0
                maps = getattr(self, f"smm_{smm_i}")(skips[i], text_embs[smm_i])  # [B,h,w,K]
                scoremaps.insert(0, torch.gather(maps, -1,
                                                 gather_idx.expand(*maps.shape[:3], 1)))
                fused_maps = conv1x1(maps, getattr(self, f"smm_fuse_{smm_i}"))
                parts.append(fused_maps.to(skips[i].dtype))
            h = torch.cat(parts, dim=-1)
            for j in range(self.num_res_blocks + 1):
                h = resblock(f"dec_{i}_{j}", h)
            if i > 0:
                h = conv_transpose_same(h, getattr(self, f"up_{i - 1}"))

        if fused:
            scale, shift = gn_channel_affine(h, self.norm_out.weight, self.norm_out.bias,
                                             self.norm_out.num_groups)
            bias = self.conv_out.bias.float()[None].expand(B, self.out_nc)
            out = fused_gn_silu_conv3x3(h, scale, shift, self.conv_out.weight, bias)
        else:
            out = conv3x3(self.norm_out(h, plain), self.conv_out)
        if self.out_nc > 1:
            pred = torch.gather(out, -1, gather_idx.expand(*out.shape[:3], 1))
        else:
            pred = out
        return pred, scoremaps
