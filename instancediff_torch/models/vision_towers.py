"""Dense CLIP vision towers and context decoders (port of
``instancediff_tpu/models/vision_towers.py``), NHWC throughout as in JAX.

- The RN family of OpenAI CLIP: ``FrozenBatchNorm`` (eval-mode BatchNorm, a
  float32 per-channel affine from stored statistics), ``Bottleneck`` (1x1,
  3x3, anti-aliased avg-pool downsample, 1x1 x4), ``AttentionPool2d`` (mean
  token plus spatial tokens plus a learned position table, one unmasked
  self-attention, ``c_proj``), ``CLIPResNetWithAttention`` (3-conv stem and
  four stages: the four stage maps and the pooled embedding) and
  ``ModifiedResNet`` (open_clip's visual ResNet: the pooled embedding only,
  optionally OpenAI-normalising [-1, 1] images itself).
- ``CLIPDenseVisionTransformer``: the OpenAI-flavour ViT with its position
  table resampled bilinearly at run time, taps at ``out_indices`` and the
  patch-16 / patch-8 FPN necks (GroupNorm(1), 2x2 transposed convs,
  FrozenBatchNorm, exact GELU, max-pool); ``get_embeddings`` adds the
  projected class and patch tokens.
- The decoders: ``ContextDecoder`` and ``ContextDecoderHierarchical`` over
  ``scoremap.ScaledDecoderLayer``; ``RefAttention``, ``RefDecoderLayer``
  (``scaled``: learned branch gammas) and ``ContextDecoderRef``.
- The torch-checkpoint loaders ``load_torch_clip_resnet_weights``,
  ``load_torch_dense_vit_weights`` and ``load_torch_context_decoder_weights``,
  which fill a module in place.

Every unmasked self-attention here (the attention pool's, the dense ViT's
blocks', ``RefDecoderLayer``'s) runs on ``ops/flash_attention.
flash_attention``: the kernel on CUDA, its plain version on the CPU. The
cross-attention of the decoders (queries and memory of other lengths) stays
on ``ops/attention.py``'s plain matmuls, as does the SMM's. Convolutions,
BatchNorm and GroupNorm are cuDNN / PyTorch calls, as JAX leaves them to
XLA."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.flash_attention import multi_head_flash
from .clip_vit import OPENAI_MEAN, OPENAI_STD
from .layers import compute_dtype, conv_same, conv_transpose_same, dense, layer_norm
from .pos_embed import resample_grid_rows
from .scoremap import ScaledDecoderLayer
from .text_encoder import TransformerBlock, read_state_dict

__all__ = ["FrozenBatchNorm", "Bottleneck", "AttentionPool2d", "CLIPResNetWithAttention",
           "ModifiedResNet", "CLIPDenseVisionTransformer", "ContextDecoder",
           "ContextDecoderHierarchical", "RefAttention", "RefDecoderLayer", "ContextDecoderRef",
           "load_torch_clip_resnet_weights", "load_torch_dense_vit_weights",
           "load_torch_context_decoder_weights", "resnet_grid"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _openai_normalize(images):
    """[-1, 1] images [B, H, W, 1|3] -> OpenAI-normalised RGB."""
    x01 = (images + 1.0) / 2.0
    if x01.shape[-1] == 1:
        x01 = x01.expand(*x01.shape[:-1], 3)
    mean = torch.tensor(OPENAI_MEAN, dtype=x01.dtype, device=x01.device)
    std = torch.tensor(OPENAI_STD, dtype=x01.dtype, device=x01.device)
    return (x01 - mean) / std


def _avg_pool(x, k: int):
    """flax ``nn.avg_pool`` (VALID) of window and stride ``k`` on NHWC."""
    return _nhwc(F.avg_pool2d(_nchw(x), k, k))


def _max_pool(x, k: int):
    """flax ``nn.max_pool`` (VALID) of window and stride ``k`` on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), k, k))


def _group_norm1(gn: nn.GroupNorm, x):
    """flax ``nn.GroupNorm(num_groups=1, dtype=float32)`` on NHWC: float32
    statistics over H, W and C per sample, float32 output."""
    return _nhwc(F.group_norm(_nchw(x.float()), 1, gn.weight, gn.bias, gn.eps))


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d in eval mode on NHWC: ``(x - mean) * rsqrt(var + eps) *
    scale + bias`` in float32, the result in x's dtype. Its parameters are
    flax's names (``scale``, ``bias``, ``mean``, ``var``), so a JAX tree and
    a torch checkpoint's ``weight``/``bias``/``running_mean``/``running_var``
    both land on them."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        y = (x.float() - self.mean.float()) * torch.rsqrt(self.var.float() + self.eps) \
            * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def _conv(cin, cout, k):
    return nn.Conv2d(cin, cout, k, bias=False)


class Bottleneck(nn.Module):
    """CLIP-ResNet bottleneck on NHWC: 1x1 -> BN -> ReLU -> 3x3 -> BN -> ReLU
    -> avg-pool by ``stride`` -> 1x1 (x4 channels) -> BN, plus the shortcut
    (avg-pool, 1x1, BN where the stride or the width changes), ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, out_ch, 1), FrozenBatchNorm(out_ch)
        if stride > 1 or inplanes != out_ch:
            self.downsample = _conv(inplanes, out_ch, 1)
            self.downsample_bn = FrozenBatchNorm(out_ch)
        else:
            self.downsample = self.downsample_bn = None

    def forward(self, x):
        h = F.relu(self.bn1(conv_same(x, self.conv1)))
        h = F.relu(self.bn2(conv_same(h, self.conv2)))
        if self.stride > 1:
            h = _avg_pool(h, self.stride)
        h = self.bn3(conv_same(h, self.conv3))
        if self.downsample is not None:
            if self.stride > 1:
                x = _avg_pool(x, self.stride)
            x = self.downsample_bn(conv_same(x, self.downsample))
        return F.relu(h + x)


class AttentionPool2d(nn.Module):
    """Global attention pooling of an [B, H, W, C] map (H * W = ``tokens``):
    the mean token and the spatial tokens plus ``positional_embedding``
    [1 + HW, C], q/k/v projections to ``embed_dim``, one unmasked
    self-attention of ``heads`` heads (the flash kernel on CUDA: RN50 at
    224 px is [B, 32, 50, 64]), ``c_proj`` to ``out_dim`` (default
    ``embed_dim``). Returns (pooled [B, out], tokens [B, HW, out])."""

    def __init__(self, tokens: int, channels: int, embed_dim: int, heads: int = 8,
                 out_dim: int = 0):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.zeros(tokens + 1, channels))
        self.q_proj = nn.Linear(channels, embed_dim)
        self.k_proj = nn.Linear(channels, embed_dim)
        self.v_proj = nn.Linear(channels, embed_dim)
        self.c_proj = nn.Linear(embed_dim, out_dim or embed_dim)

    def forward(self, x):
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C)
        seq = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        seq = seq + self.positional_embedding.to(seq.dtype)[None]
        attn = multi_head_flash(dense(self.q_proj, seq), dense(self.k_proj, seq),
                                dense(self.v_proj, seq), self.heads)
        out = dense(self.c_proj, attn)
        return out[:, 0], out[:, 1:]


def resnet_grid(image_size: int) -> int:
    """The side of the CLIP ResNet's last map for ``image_size`` px: the
    stem's stride-2 conv (torch padding 1), its 2x2 avg-pool and the three
    strided stages' 2x2 avg-pools (7 at 224 px)."""
    side = (image_size - 1) // 2 + 1
    for _ in range(4):
        side //= 2
    return side


class CLIPResNetWithAttention(nn.Module):
    """Multi-scale CLIP ResNet on NHWC: the 3-conv stem (the first conv at
    stride 2 with torch's padding of (1, 1), not flax's SAME), a 2x2
    avg-pool, four stages of ``layers`` bottlenecks (planes ``width`` x 1, 2,
    4, 8; stride 2 from the second stage on), and the attention pool over
    the last map (``width * 32`` channels, square q/k/v, ``heads`` heads, to
    ``output_dim``). ``forward(x [B, image_size, image_size, in_ch]) ->
    ([4 stage maps], pooled [B, output_dim])``; the pool's position table
    fits ``image_size``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 512, heads: int = 8, image_size: int = 224, in_ch: int = 3):
        super().__init__()
        w = width
        self.layers = tuple(layers)
        self.conv1, self.bn1 = nn.Conv2d(in_ch, w // 2, 3, bias=False), FrozenBatchNorm(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3), FrozenBatchNorm(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3), FrozenBatchNorm(w)
        inplanes, planes = w, w
        for si, n_blocks in enumerate(self.layers):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                self.add_module(f"layer{si}_{bi}", Bottleneck(inplanes, planes, stride))
                inplanes = planes * 4
            planes *= 2
        side = resnet_grid(image_size)
        self.attnpool = AttentionPool2d(side * side, width * 32, width * 32, heads=heads,
                                        out_dim=output_dim)

    def forward(self, x):
        dt = compute_dtype(self.conv1)
        h = _nhwc(F.conv2d(_nchw(x.to(dt)), self.conv1.weight.to(dt), stride=2, padding=1))
        h = F.relu(self.bn1(h))
        h = F.relu(self.bn2(conv_same(h, self.conv2)))
        h = F.relu(self.bn3(conv_same(h, self.conv3)))
        h = _avg_pool(h, 2)
        outs = []
        for si, n_blocks in enumerate(self.layers):
            for bi in range(n_blocks):
                h = getattr(self, f"layer{si}_{bi}")(h)
            outs.append(h)
        pooled, _ = self.attnpool(h)
        return outs, pooled


class ModifiedResNet(nn.Module):
    """open_clip's visual ResNet: ``CLIPResNetWithAttention`` as ``trunk``,
    returning the pooled embedding [B, output_dim] only. With
    ``openai_normalize`` it takes [-1, 1] images of 1 or 3 channels and
    applies the OpenAI eval normalisation itself (the ViT tower's
    contract)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 512, heads: int = 8, openai_normalize: bool = False,
                 image_size: int = 224, in_ch: int = 3):
        super().__init__()
        self.openai_normalize = openai_normalize
        self.trunk = CLIPResNetWithAttention(layers, width, output_dim, heads, image_size,
                                             3 if openai_normalize else in_ch)

    def forward(self, x):
        if self.openai_normalize:
            x = _openai_normalize(x)
        return self.trunk(x)[1]


class CLIPDenseVisionTransformer(nn.Module):
    """The reference's dense ViT tower on NHWC: OpenAI normalisation, a
    bias-free PxP patch conv, ``class_embedding`` and a position table of
    the ``image_size // patch_size`` grid (resized at run time by bilinear
    interpolation without antialiasing, ``F.interpolate(align_corners=
    False)``, for another grid), ``ln_pre``, ``layers`` OpenAI blocks
    (QuickGELU, eps 1e-5; unmasked, so on the flash kernel on CUDA), taps at
    ``out_indices`` and the FPN necks of ``patch_size`` 16 or 8. The class
    token receives ``class_embedding`` twice, as in the reference (once in
    the token cat, once in the class row's position). Returns the four
    neck maps and, with ``get_embeddings``, ``[global [B, output_dim],
    visual [B, gh, gw, output_dim]]`` after them (``ln_post`` and ``proj``)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 out_indices: Sequence[int] = (3, 5, 7, 11), get_embeddings: bool = False):
        super().__init__()
        if patch_size not in (8, 16):
            raise ValueError(f"the dense ViT's necks take patch_size 16 or 8, not {patch_size}")
        self.patch_size, self.width, self.layers = patch_size, width, layers
        self.out_indices = tuple(out_indices)
        self.get_embeddings = get_embeddings
        self.side = image_size // patch_size
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(self.side * self.side + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, act="quick_gelu",
                                                           ln_eps=1e-5))

        def gn():
            return nn.GroupNorm(1, width, eps=1e-5)

        def deconv():
            return nn.ConvTranspose2d(width, width, 2, stride=2)

        if patch_size == 16:
            self.fpn1_gn, self.fpn1_deconv1 = gn(), deconv()
            self.fpn1_bn, self.fpn1_deconv2 = FrozenBatchNorm(width), deconv()
            self.fpn2_gn, self.fpn2_deconv = gn(), deconv()
            self.fpn3_gn, self.fpn4_gn = gn(), gn()
        else:
            self.fpn1_gn, self.fpn1_deconv = gn(), deconv()
            self.fpn2_gn, self.fpn3_gn, self.fpn4_gn = gn(), gn(), gn()
        if get_embeddings:
            self.ln_post = nn.LayerNorm(width, eps=1e-5)
            self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, images):
        B = images.shape[0]
        x = conv_same(_openai_normalize(images), self.patch_embed, stride=self.patch_size)
        gh, gw = x.shape[1], x.shape[2]
        tokens = x.reshape(B, gh * gw, self.width)
        cls = self.class_embedding
        spatial = self.positional_embedding[1:].reshape(self.side, self.side, self.width)
        if (gh, gw) != (self.side, self.side):
            spatial = _nhwc(F.interpolate(_nchw(spatial[None].float()), size=(gh, gw),
                                          mode="bilinear", align_corners=False))[0]
        cls_pos = (self.positional_embedding[0] + cls)[None, None]
        full_pos = torch.cat([cls_pos, spatial.reshape(1, gh * gw, self.width)], dim=1)
        tokens = torch.cat([cls.to(tokens.dtype).expand(B, 1, self.width), tokens], dim=1)
        tokens = layer_norm(self.ln_pre, tokens + full_pos.to(tokens.dtype))
        taps = []
        for i in range(self.layers):
            tokens = getattr(self, f"block_{i}")(tokens)
            if i in self.out_indices:
                taps.append(tokens[:, 1:].reshape(B, gh, gw, self.width))
        if self.patch_size == 16:
            h = conv_transpose_same(_group_norm1(self.fpn1_gn, taps[0]), self.fpn1_deconv1)
            h = F.gelu(self.fpn1_bn(h))
            feats = [conv_transpose_same(h, self.fpn1_deconv2),
                     conv_transpose_same(_group_norm1(self.fpn2_gn, taps[1]), self.fpn2_deconv),
                     _group_norm1(self.fpn3_gn, taps[2]),
                     _max_pool(_group_norm1(self.fpn4_gn, taps[3]), 2)]
        else:
            feats = [conv_transpose_same(_group_norm1(self.fpn1_gn, taps[0]), self.fpn1_deconv),
                     _group_norm1(self.fpn2_gn, taps[1]),
                     _max_pool(_group_norm1(self.fpn3_gn, taps[2]), 2),
                     _max_pool(_group_norm1(self.fpn4_gn, taps[3]), 4)]
        if self.get_embeddings:
            out = layer_norm(self.ln_post, tokens)
            out = out @ self.proj.to(out.dtype)
            feats.append([out[:, 0], out[:, 1:].reshape(B, gh, gw, -1)])
        return feats


class ContextDecoder(nn.Module):
    """Text queries [B, K, dim] against one visual memory [B, M, dim]:
    ``layers`` ``ScaledDecoderLayer``s (cross-attention and MLP with learned
    branch scales)."""

    def __init__(self, dim: int = 512, layers: int = 3, heads: int = 4):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}", ScaledDecoderLayer(dim, heads))

    def forward(self, queries, memory):
        q = queries
        for i in range(self.layers):
            q = getattr(self, f"layer_{i}")(q, memory)
        return q


class ContextDecoderHierarchical(nn.Module):
    """``ContextDecoder`` over several memories: scale i of ``use_scales``
    (those below ``len(mem_dims)``, its channels ``mem_dims[i]``) projected
    to ``dim`` by ``mem_proj_{i}``, the projections concatenated along the
    tokens."""

    def __init__(self, mem_dims: Sequence[int], dim: int = 512, layers: int = 3,
                 heads: int = 4, use_scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.scales = [i for i in use_scales if i < len(mem_dims)]
        self.layers = layers
        for i in self.scales:
            self.add_module(f"mem_proj_{i}", nn.Linear(mem_dims[i], dim))
        for i in range(layers):
            self.add_module(f"layer_{i}", ScaledDecoderLayer(dim, heads))

    def forward(self, queries, memories):
        if len(memories) <= max(self.scales):
            raise ValueError(f"{len(memories)} memories for scales {self.scales}")
        memory = torch.cat([dense(getattr(self, f"mem_proj_{i}"), memories[i])
                            for i in self.scales], dim=1)
        q = queries
        for i in range(self.layers):
            q = getattr(self, f"layer_{i}")(q, memory)
        return q


class RefAttention(nn.Module):
    """The reference's ``Attention``: q/k/v projections (biased with
    ``qkv_bias``), split-head attention, a biased ``proj``. ``self_attention``
    marks the use with q = k = v (one length), which runs on the flash
    kernel; otherwise the plain matmuls."""

    def __init__(self, dim: int, heads: int = 4, qkv_bias: bool = False,
                 self_attention: bool = False):
        super().__init__()
        self.heads = heads
        self.self_attention = self_attention
        self.q_proj = nn.Linear(dim, dim, bias=qkv_bias)
        self.k_proj = nn.Linear(dim, dim, bias=qkv_bias)
        self.v_proj = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        qq, kk, vv = dense(self.q_proj, q), dense(self.k_proj, k), dense(self.v_proj, v)
        if self.self_attention:
            out = multi_head_flash(qq, kk, vv, self.heads)
        else:
            out = multi_head_attention(qq, kk, vv, self.heads)
        return dense(self.proj, out)


class RefDecoderLayer(nn.Module):
    """The reference's decoder layer (``scaled``: with learned branch gammas
    ``gamma_sa``/``gamma_ca``/``gamma_mlp`` [1, 1, dim], 0.1 at init):
    ``x += self_attn(norm1(x))``, ``x += cross_attn(norm2(x), mem, mem)``
    (the memory not normalised again), ``x += proj(gelu(fc(norm3(x))))``,
    exact GELU, eps 1e-5."""

    def __init__(self, dim: int, heads: int = 4, scaled: bool = False):
        super().__init__()
        self.scaled = scaled
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = RefAttention(dim, heads, self_attention=True)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = RefAttention(dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.fc = nn.Linear(dim, dim * 4)
        self.proj = nn.Linear(dim * 4, dim)
        if scaled:
            for name in ("gamma_sa", "gamma_ca", "gamma_mlp"):
                setattr(self, name, nn.Parameter(torch.full((1, 1, dim), 0.1)))

    def _gamma(self, name, h):
        return h * getattr(self, name).to(h.dtype) if self.scaled else h

    def forward(self, x, mem):
        h = layer_norm(self.norm1, x)
        x = x + self._gamma("gamma_sa", self.self_attn(h, h, h))
        q = layer_norm(self.norm2, x)
        x = x + self._gamma("gamma_ca", self.cross_attn(q, mem, mem))
        h = dense(self.proj, F.gelu(dense(self.fc, layer_norm(self.norm3, x))))
        return x + self._gamma("gamma_mlp", h)


class ContextDecoderRef(nn.Module):
    """The reference's ``ContextDecoder`` (``scaled=False``) and the forward
    of its hierarchical variants (``scaled=True``, one memory projection):
    visual [B, M, visual_dim] -> ``mem_ln0``, ``mem_fc``, ``mem_ln1``; text
    [B, K, text_dim] -> ``text_ln``, ``text_fc``; ``layers``
    ``RefDecoderLayer``s; ``out_ln``, ``out_fc`` -> [B, K, out_dim]."""

    def __init__(self, width: int = 256, heads: int = 4, layers: int = 6,
                 visual_dim: int = 512, text_dim: int = 512, out_dim: int = 512,
                 scaled: bool = False):
        super().__init__()
        self.layers = layers
        self.mem_ln0 = nn.LayerNorm(visual_dim, eps=1e-5)
        self.mem_fc = nn.Linear(visual_dim, width)
        self.mem_ln1 = nn.LayerNorm(width, eps=1e-5)
        self.text_ln = nn.LayerNorm(text_dim, eps=1e-5)
        self.text_fc = nn.Linear(text_dim, width)
        for i in range(layers):
            self.add_module(f"layer_{i}", RefDecoderLayer(width, heads, scaled=scaled))
        self.out_ln = nn.LayerNorm(width, eps=1e-5)
        self.out_fc = nn.Linear(width, out_dim)

    def forward(self, text, visual):
        m = layer_norm(self.mem_ln1, dense(self.mem_fc, layer_norm(self.mem_ln0, visual)))
        x = dense(self.text_fc, layer_norm(self.text_ln, text))
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, m)
        return dense(self.out_fc, layer_norm(self.out_ln, x))


# ---------------------------------------------------------------- loaders


class _Filler:
    """Copies a state dict's tensors into parameters, checking shapes."""

    def __init__(self, state_dict, prefix: str = ""):
        sd = read_state_dict(state_dict)
        self.sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
                   for k, v in sd.items()}

    def __contains__(self, key):
        return key in self.sd

    def get(self, key) -> torch.Tensor:
        v = self.sd[key]
        if torch.is_tensor(v):
            return v.detach().float().cpu()
        return torch.from_numpy(np.asarray(v, dtype=np.float32))

    @staticmethod
    def put(param, value):
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint gives shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    def linear(self, lin, key, bias: bool = True):
        self.put(lin.weight, self.get(key + ".weight"))
        if bias and key + ".bias" in self:
            self.put(lin.bias, self.get(key + ".bias"))

    def norm(self, ln, key):
        self.put(ln.weight, self.get(key + ".weight"))
        self.put(ln.bias, self.get(key + ".bias"))

    def bn(self, fbn: FrozenBatchNorm, key):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            self.put(getattr(fbn, ours), self.get(f"{key}.{theirs}"))


def load_torch_clip_resnet_weights(model, state_dict, prefix: str = "visual."):
    """Fill a ``CLIPResNetWithAttention`` or ``ModifiedResNet`` in place from
    an OpenAI-CLIP / open_clip ``ModifiedResNet`` visual state dict (a path,
    a TorchScript archive or the mapping; keys under ``prefix``): the stem's
    ``conv{1,2,3}``/``bn{1,2,3}``, ``layer{s+1}.{b}.*`` onto ``layer{s}_{b}``
    (BatchNorm ``weight``/``bias``/``running_mean``/``running_var`` onto
    FrozenBatchNorm's ``scale``/``bias``/``mean``/``var``; ``downsample.0``
    and ``.1`` onto ``downsample`` and ``downsample_bn``) and the attention
    pool, whose position table is resampled bilinearly when the checkpoint's
    grid differs from the model's (``pos_embed.resample_grid_rows``). Returns
    the model."""
    fill = _Filler(state_dict, prefix)
    trunk = model.trunk if isinstance(model, ModifiedResNet) else model
    with torch.no_grad():
        for i in (1, 2, 3):
            fill.put(getattr(trunk, f"conv{i}").weight, fill.get(f"conv{i}.weight"))
            fill.bn(getattr(trunk, f"bn{i}"), f"bn{i}")
        for si, n_blocks in enumerate(trunk.layers):
            for bi in range(n_blocks):
                blk, t = getattr(trunk, f"layer{si}_{bi}"), f"layer{si + 1}.{bi}"
                for i in (1, 2, 3):
                    fill.put(getattr(blk, f"conv{i}").weight, fill.get(f"{t}.conv{i}.weight"))
                    fill.bn(getattr(blk, f"bn{i}"), f"{t}.bn{i}")
                if blk.downsample is not None:
                    fill.put(blk.downsample.weight, fill.get(f"{t}.downsample.0.weight"))
                    fill.bn(blk.downsample_bn, f"{t}.downsample.1")
        ap = trunk.attnpool
        fill.put(ap.positional_embedding,
                 resample_grid_rows(fill.get("attnpool.positional_embedding").numpy(),
                                    ap.positional_embedding.shape[0] - 1))
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            fill.linear(getattr(ap, name), f"attnpool.{name}")
    return model


def load_torch_dense_vit_weights(tower: CLIPDenseVisionTransformer, state_dict,
                                 prefix: str = "visual."):
    """Fill a ``CLIPDenseVisionTransformer`` in place from a torch
    ``CLIPVisionTransformer`` / OpenAI visual state dict (keys under
    ``prefix``): ``conv1``, ``class_embedding``, ``positional_embedding``
    (resampled bilinearly to the tower's grid), ``ln_pre``/``ln_post``,
    ``proj`` where the tower has them, ``transformer.resblocks.{i}`` onto
    ``block_{i}`` (``in_proj`` split into q/k/v) while both have the block,
    and the FPN necks' keys where the checkpoint has them (torch's
    Sequential indices; ``ConvTranspose2d`` weights as torch lays them out,
    which is what the tower's modules hold). Returns the tower."""
    fill = _Filler(state_dict, prefix)
    with torch.no_grad():
        fill.put(tower.patch_embed.weight, fill.get("conv1.weight"))
        fill.put(tower.class_embedding, fill.get("class_embedding"))
        fill.put(tower.positional_embedding,
                 resample_grid_rows(fill.get("positional_embedding").numpy(),
                                    tower.positional_embedding.shape[0] - 1))
        for ln in ("ln_pre", "ln_post"):
            if f"{ln}.weight" in fill and hasattr(tower, ln):
                fill.norm(getattr(tower, ln), ln)
        if "proj" in fill and hasattr(tower, "proj"):
            fill.put(tower.proj, fill.get("proj"))
        for i in range(tower.layers):
            R = f"transformer.resblocks.{i}"
            if f"{R}.ln_1.weight" not in fill:
                break
            blk = getattr(tower, f"block_{i}")
            fill.norm(blk.ln_1, f"{R}.ln_1")
            fill.norm(blk.ln_2, f"{R}.ln_2")
            w, b = fill.get(f"{R}.attn.in_proj_weight"), fill.get(f"{R}.attn.in_proj_bias")
            for lin, wp, bp in zip((blk.q_proj, blk.k_proj, blk.v_proj), w.chunk(3), b.chunk(3)):
                fill.put(lin.weight, wp)
                fill.put(lin.bias, bp)
            fill.linear(blk.out_proj, f"{R}.attn.out_proj")
            fill.linear(blk.fc, f"{R}.mlp.c_fc")
            fill.linear(blk.proj, f"{R}.mlp.c_proj")

        def neck(module, key):
            if f"{key}.weight" in fill:
                fill.linear(module, key)

        if tower.patch_size == 16:
            neck(tower.fpn1_gn, "fpn1.0")
            neck(tower.fpn1_deconv1, "fpn1.1")
            if "fpn1.2.weight" in fill:
                fill.bn(tower.fpn1_bn, "fpn1.2")
            neck(tower.fpn1_deconv2, "fpn1.4")
            neck(tower.fpn2_gn, "fpn2.0")
            neck(tower.fpn2_deconv, "fpn2.1")
            neck(tower.fpn3_gn, "fpn3")
            neck(tower.fpn4_gn, "fpn4.0")
        else:
            neck(tower.fpn1_gn, "fpn1.0")
            neck(tower.fpn1_deconv, "fpn1.1")
            neck(tower.fpn2_gn, "fpn2")
            neck(tower.fpn3_gn, "fpn3.0")
            neck(tower.fpn4_gn, "fpn4.0")
    return tower


def load_torch_context_decoder_weights(decoder: ContextDecoderRef, state_dict):
    """Fill a ``ContextDecoderRef`` in place from a torch ``ContextDecoder``
    or ``ContextDecoder_Hierachical`` state dict (the hierarchical one's
    scale-0 ``memory_proj_0``; its other scales are unused by its forward):
    ``memory_proj``, ``text_proj``, ``decoder.{i}`` (norms, both attentions'
    q/k/v (biases where present) and ``proj``, ``mlp.0``/``mlp.3``, gammas
    where present) and ``out_proj``. Returns the decoder."""
    fill = _Filler(state_dict)
    mp = "memory_proj_0" if "memory_proj_0.0.weight" in fill else "memory_proj"
    d = decoder
    with torch.no_grad():
        fill.norm(d.mem_ln0, f"{mp}.0")
        fill.linear(d.mem_fc, f"{mp}.1")
        fill.norm(d.mem_ln1, f"{mp}.2")
        fill.norm(d.text_ln, "text_proj.0")
        fill.linear(d.text_fc, "text_proj.1")
        for i in range(d.layers):
            lp, t = getattr(d, f"layer_{i}"), f"decoder.{i}"
            for ln in ("norm1", "norm2", "norm3"):
                fill.norm(getattr(lp, ln), f"{t}.{ln}")
            for attn in ("self_attn", "cross_attn"):
                mod = getattr(lp, attn)
                for proj in ("q_proj", "k_proj", "v_proj"):
                    lin = getattr(mod, proj)
                    fill.put(lin.weight, fill.get(f"{t}.{attn}.{proj}.weight"))
                    if f"{t}.{attn}.{proj}.bias" in fill and lin.bias is not None:
                        fill.put(lin.bias, fill.get(f"{t}.{attn}.{proj}.bias"))
                fill.linear(mod.proj, f"{t}.{attn}.proj")
            fill.linear(lp.fc, f"{t}.mlp.0")
            fill.linear(lp.proj, f"{t}.mlp.3")
            for g in ("gamma_sa", "gamma_ca", "gamma_mlp"):
                if f"{t}.{g}" in fill and lp.scaled:
                    fill.put(getattr(lp, g), fill.get(f"{t}.{g}"))
        fill.norm(d.out_ln, "out_proj.0")
        fill.linear(d.out_fc, "out_proj.1")
    return decoder
