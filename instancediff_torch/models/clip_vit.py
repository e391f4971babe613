"""The CLIP / BiomedCLIP image tower, a ViT (port of
``instancediff_tpu/models/clip_vit.py``): it embeds the degraded input
``mu`` as the image context ``emb_A`` on the device (``drift_model.
CLIPDriftEngine.attach_image_tower``) and is BiomedCLIP's visual tower
(``biomedclip.py``).

``[-1, 1]`` -> ``[0, 1]`` -> grey to RGB -> OpenAI mean/std -> PxP patch
conv -> class token + position table -> pre-LN blocks -> ``ln_post`` ->
class-token pool -> bias-free ``proj``. Two flavours (``FLAVOURS``): timm /
BiomedCLIP (exact GELU, LayerNorm eps 1e-6, no ``ln_pre``; the default, and
what ``build_image_tower`` builds) and OpenAI (QuickGELU, eps 1e-5,
``ln_pre``; what OpenAI's checkpoints hold). The blocks' self-attention is
unmasked and runs the flash kernel on CUDA, which takes 64-wide heads
(ViT-B/16: 12 heads of 64): a tower with other head widths runs on the CPU
only. The tower is frozen: PatchDropout and DropPath, the training-only
options of the JAX tower, are refused."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import conv_same, dense, layer_norm
from .pos_embed import get_2d_sincos_pos_embed, interpolate_pos_embed
from .text_encoder import TransformerBlock, read_state_dict

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
# flavour -> (activation, LayerNorm eps, ln_pre)
FLAVOURS = {"timm": ("gelu", 1e-6, False), "openai": ("quick_gelu", 1e-5, True)}


class CLIPVisionTower(nn.Module):
    """``forward(images [B, H, W, C in [-1, 1]]) -> [B, embed_dim]``. The
    patch conv is flax's SAME-padded strided conv. ``flavour``: a
    ``FLAVOURS`` key; ``pos_embed_type``: ``"learnable"`` or
    ``"sin_cos_2d"`` (the table starts at the fixed 2-D sin-cos values of
    the ``image_size // patch_size`` grid); ``ls_init``: LayerScale in every
    block. ``patch_dropout`` and ``drop_path_rate`` other than 0 raise
    (training-only, not ported). Compute dtype: ``layers.cast_compute_``
    (norms in float32, as in JAX)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, embed_dim: int = 512,
                 flavour: str = "timm", pos_embed_type: str = "learnable", ls_init=None,
                 patch_dropout: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        if patch_dropout or drop_path_rate:
            raise NotImplementedError(
                "PatchDropout and DropPath are training-only and not ported: the image tower "
                "is frozen (ROADMAP queue 1 item 5)")
        if flavour not in FLAVOURS:
            raise ValueError(f"unknown flavour {flavour!r}; valid: {sorted(FLAVOURS)}")
        if pos_embed_type not in ("learnable", "sin_cos_2d"):
            raise ValueError(f"unknown pos_embed_type {pos_embed_type!r}")
        act, ln_eps, use_ln_pre = FLAVOURS[flavour]
        self.patch_size = patch_size
        self.width = width
        self.layers = layers
        grid = -(-image_size // patch_size)
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.from_numpy(get_2d_sincos_pos_embed(width, grid, cls_token=True))
            if pos_embed_type == "sin_cos_2d" else torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=ln_eps) if use_ln_pre else None
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, act=act, ln_eps=ln_eps,
                                                           ls_init=ls_init))
        self.ln_post = nn.LayerNorm(width, eps=ln_eps)
        self.proj = nn.Linear(width, embed_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        x01 = (images + 1.0) / 2.0
        if C == 1:
            x01 = x01.expand(B, H, W, 3)
        mean = torch.tensor(OPENAI_MEAN, dtype=x01.dtype, device=x01.device)
        std = torch.tensor(OPENAI_STD, dtype=x01.dtype, device=x01.device)
        x = conv_same((x01 - mean) / std, self.patch_embed, stride=self.patch_size)
        x = x.reshape(B, -1, self.width)
        x = torch.cat([self.class_token.to(x.dtype).expand(B, 1, self.width), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)[None]
        if self.ln_pre is not None:
            x = layer_norm(self.ln_pre, x)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        x = layer_norm(self.ln_post, x)
        return dense(self.proj, x[:, 0])


def build_image_tower(embed_dim: int = 512, tiny: bool = False,
                      image_size: int | None = None) -> CLIPVisionTower:
    """The timm / BiomedCLIP ViT-B/16, or the ``tiny`` test size (patch 8,
    width 32, 2 layers, 4 heads), in float32, for inputs of ``image_size``
    (default 224, tiny 32): the position table has a row per patch of that
    grid plus the class row, as the JAX tower initialised on such an input
    has."""
    if tiny:
        return CLIPVisionTower(image_size=image_size or 32, patch_size=8, width=32, layers=2,
                               heads=4, embed_dim=embed_dim)
    return CLIPVisionTower(image_size=image_size or 224, embed_dim=embed_dim)


def image_context(tower: CLIPVisionTower, images: torch.Tensor) -> torch.Tensor:
    """The image context of ``images``: the tower's float32 embedding,
    L2-normalised (the norm clamped at 1e-8), as one token [B, 1, E]."""
    emb = tower(images.float()).float()
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-8)
    return emb[:, None, :]


def encode_image_fn(tower: CLIPVisionTower, normalize: bool = True):
    """``f(images) -> emb [B, 1, E]``, the ``A_emb`` channel's shape."""
    def f(images):
        if normalize:
            return image_context(tower, images)
        return tower(images)[:, None, :]

    return f


def load_torch_clip_vision_weights(tower: CLIPVisionTower, checkpoint_path_or_sd
                                   ) -> CLIPVisionTower:
    """Fill ``tower`` in place from an open_clip / timm (``visual.trunk.*``,
    fused ``qkv``) or OpenAI (``visual.conv1``, ``visual.transformer.
    resblocks.*`` with ``in_proj_weight``; torch.jit archives too) ViT state
    dict: a path or the dict itself. A position table of another grid is
    resampled (``pos_embed.interpolate_pos_embed``); OpenAI's bias-free
    patch conv zeroes the tower's bias; LayerScale gammas load where both
    have them; a checkpoint deeper than the tower fills its blocks. Keys the
    checkpoint lacks keep their values."""
    sd = read_state_dict(checkpoint_path_or_sd)

    def get(key):
        return torch.as_tensor(sd[key]).detach().float().cpu()

    def first(*keys):
        return next((k for k in keys if k in sd), None)

    def put(param, value):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint gives shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    def linear(lin, prefix):
        put(lin.weight, get(prefix + ".weight"))
        put(lin.bias, get(prefix + ".bias"))

    with torch.no_grad():
        k = first("visual.trunk.patch_embed.proj.weight", "visual.conv1.weight")
        if k:
            put(tower.patch_embed.weight, get(k))
            bk = k.replace("weight", "bias")
            put(tower.patch_embed.bias, get(bk) if bk in sd
                else torch.zeros_like(tower.patch_embed.bias))
        k = first("visual.trunk.cls_token", "visual.class_embedding")
        if k:
            put(tower.class_token, get(k).reshape(1, 1, -1))
        k = first("visual.trunk.pos_embed", "visual.positional_embedding")
        if k:
            pos = get(k).reshape(-1, tower.width)
            put(tower.pos_embed, interpolate_pos_embed(pos, tower.pos_embed.shape[0]))
        k = first("visual.head.proj.weight", "visual.proj")
        if k:
            w = get(k)  # flax kernel [width, embed]: taken as is, or transposed
            kernel = w.T if w.shape[0] == tower.proj.weight.shape[0] else w
            put(tower.proj.weight, kernel.T)
        if "visual.ln_pre.weight" in sd and tower.ln_pre is not None:
            linear(tower.ln_pre, "visual.ln_pre")
        for i in range(tower.layers):
            blk = getattr(tower, f"block_{i}")
            R, T = f"visual.transformer.resblocks.{i}", f"visual.trunk.blocks.{i}"
            if f"{R}.ln_1.weight" in sd:  # OpenAI
                linear(blk.ln_1, f"{R}.ln_1")
                linear(blk.ln_2, f"{R}.ln_2")
                w, b = get(f"{R}.attn.in_proj_weight"), get(f"{R}.attn.in_proj_bias")
                for lin, wp, bp in zip((blk.q_proj, blk.k_proj, blk.v_proj), w.chunk(3),
                                       b.chunk(3)):
                    put(lin.weight, wp)
                    put(lin.bias, bp)
                linear(blk.out_proj, f"{R}.attn.out_proj")
                linear(blk.fc, f"{R}.mlp.c_fc")
                linear(blk.proj, f"{R}.mlp.c_proj")
                gammas = (f"{R}.ls_1.gamma", f"{R}.ls_2.gamma")
            else:  # open_clip / timm trunk
                if f"{T}.norm1.weight" in sd:
                    linear(blk.ln_1, f"{T}.norm1")
                    linear(blk.ln_2, f"{T}.norm2")
                if f"{T}.attn.qkv.weight" in sd:
                    w, b = get(f"{T}.attn.qkv.weight"), get(f"{T}.attn.qkv.bias")
                    for lin, wp, bp in zip((blk.q_proj, blk.k_proj, blk.v_proj), w.chunk(3),
                                           b.chunk(3)):
                        put(lin.weight, wp)
                        put(lin.bias, bp)
                    linear(blk.out_proj, f"{T}.attn.proj")
                    linear(blk.fc, f"{T}.mlp.fc1")
                    linear(blk.proj, f"{T}.mlp.fc2")
                gammas = (f"{T}.ls1.gamma", f"{T}.ls2.gamma")
            for key, gamma in zip(gammas, (blk.ls_1, blk.ls_2)):
                if key in sd and gamma is not None:
                    put(gamma, get(key))
        k = first("visual.trunk.norm.weight", "visual.ln_post.weight")
        if k:
            linear(tower.ln_post, k[: -len(".weight")])
    return tower
