"""Frozen text towers with learnable-context splicing (port of
``instancediff_tpu/models/text_encoder.py``): the pre-LN ``TransformerBlock``
(the CLIP text tower's and the ViT image tower's), the CLIP text tower
``CLIPTextContextEncoder`` and its checkpoint loader, and the post-LN
PubMedBERT tower of BiomedCLIP, ``HFContextTextEncoder``, with its poolers
and checkpoint loader. ``resize_text_pos_embed`` lives in ``pos_embed.py``
and is re-exported here.

The BERT tower's attention is masked and stays on ``ops/attention.py``'s
plain matmuls, as the JAX package leaves it to XLA's einsum; the ViT
tower's (``clip_vit.py``) is unmasked and runs the flash kernel on CUDA."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import clamp_qkv, drop_path, multi_head_attention
from ..ops.flash_attention import multi_head_flash
from .layers import compute_dtype, dense, layer_norm
from .pos_embed import resize_text_pos_embed

__all__ = ["TransformerBlock", "CLIPTextContextEncoder", "HFContextTextEncoder",
           "PostLNBertLayer", "POOLERS", "build_text_encoder", "exact_gelu", "quick_gelu",
           "load_torch_bert_weights", "load_torch_clip_text_weights", "read_state_dict",
           "resize_text_pos_embed"]


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x):
    """erf-based GELU (HF BERT's 'gelu', torch's ``nn.GELU`` default)."""
    return F.gelu(x)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + drop_path(ls_1 * out_proj(attn(ln_1(x))))``, then
    ``x + drop_path(ls_2 * proj(act(fc(ln_2(x)))))``. ``act``:
    ``"quick_gelu"`` (OpenAI CLIP) or ``"gelu"`` (exact erf GELU, timm and
    HF towers); ``ln_eps``: 1e-5 (OpenAI) or 1e-6 (timm); ``ls_init``:
    LayerScale gammas ``ls_1``/``ls_2`` of that initial value (none by
    default); ``qkv_clamp``: q/k/v bounded to +-clamp before the attention
    (the reference's fp16 overflow guard); ``drop_path_rate``: stochastic
    depth on both branches, only with ``deterministic=False`` (one draw per
    branch from ``rng``, ``ops/attention.draw``). A masked attention (the
    text tower's causal mask) runs on ``ops/attention.py``'s plain matmuls;
    an unmasked one (the image towers') on ``ops/flash_attention.
    flash_attention``: the kernel on CUDA, its plain version on the CPU."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0,
                 act: str = "quick_gelu", ln_eps: float = 1e-5,
                 ls_init: Optional[float] = None, drop_path_rate: float = 0.0,
                 qkv_clamp: Optional[float] = None):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown act {act!r} (quick_gelu or gelu)")
        self.heads = heads
        self.drop_path_rate = drop_path_rate
        self.qkv_clamp = qkv_clamp
        self.act = quick_gelu if act == "quick_gelu" else exact_gelu
        self.ln_1 = nn.LayerNorm(width, eps=ln_eps)
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=ln_eps)
        self.fc = nn.Linear(width, int(width * mlp_ratio))
        self.proj = nn.Linear(int(width * mlp_ratio), width)
        if ls_init is not None:
            self.ls_1 = nn.Parameter(torch.full((width,), float(ls_init)))
            self.ls_2 = nn.Parameter(torch.full((width,), float(ls_init)))
        else:
            self.ls_1 = self.ls_2 = None

    def _attention(self, q, k, v, mask):
        if mask is not None:
            return multi_head_attention(q, k, v, self.heads, mask=mask,
                                        qkv_clamp=self.qkv_clamp)
        return multi_head_flash(*clamp_qkv(q, k, v, self.qkv_clamp), self.heads)

    def _branch(self, h, gamma, deterministic, rng):
        h = h if gamma is None else h * gamma.to(h.dtype)
        if self.drop_path_rate > 0.0 and not deterministic:
            return drop_path(h, self.drop_path_rate, rng)
        return h

    def forward(self, x, mask=None, deterministic: bool = True, rng=None):
        h = layer_norm(self.ln_1, x)
        attn = self._attention(dense(self.q_proj, h), dense(self.k_proj, h),
                               dense(self.v_proj, h), mask)
        x = x + self._branch(dense(self.out_proj, attn), self.ls_1, deterministic, rng)
        h = self.act(dense(self.fc, layer_norm(self.ln_2, x)))
        return x + self._branch(dense(self.proj, h), self.ls_2, deterministic, rng)


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
        tok = self.token_embedding(ids.long()).to(compute_dtype(self.token_embedding))
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


class PostLNBertLayer(nn.Module):
    """Post-LN BERT encoder layer (HF ``BertLayer``): ``x = attn_ln(x +
    out_proj(attn(x)))``, ``x = ffn_ln(x + proj(gelu(fc(x))))``; eps 1e-12
    (roberta-family configs 1e-5), exact erf GELU, float32 softmax, the
    additive ``mask`` on ``ops/attention.py``'s plain matmuls."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, ln_eps: float = 1e-12):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.attn_ln = nn.LayerNorm(width, eps=ln_eps)
        self.fc = nn.Linear(width, int(width * mlp_ratio))
        self.proj = nn.Linear(int(width * mlp_ratio), width)
        self.ffn_ln = nn.LayerNorm(width, eps=ln_eps)

    def forward(self, x, mask=None):
        attn = multi_head_attention(dense(self.q_proj, x), dense(self.k_proj, x),
                                    dense(self.v_proj, x), self.heads, mask=mask)
        x = layer_norm(self.attn_ln, x + dense(self.out_proj, attn))
        h = dense(self.proj, exact_gelu(dense(self.fc, x)))
        return layer_norm(self.ffn_ln, x + h)


def mean_pooler(hidden, mask):
    """Masked mean over the sequence."""
    m = mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-8)


def max_pooler(hidden, mask):
    """Masked max over the sequence (the padding masked out)."""
    return torch.where(mask[..., None] > 0, hidden,
                       torch.tensor(float("-inf"), dtype=hidden.dtype,
                                    device=hidden.device)).amax(dim=1)


def cls_pooler(hidden, mask):
    """The [CLS] position's last hidden state."""
    del mask
    return hidden[:, 0]


# open_clip's pooler registry, snake-cased as in the JAX package
POOLERS = {"mean_pooler": mean_pooler, "max_pooler": max_pooler, "cls_pooler": cls_pooler,
           "cls_last_hidden_state_pooler": cls_pooler}


class HFContextTextEncoder(nn.Module):
    """The PubMedBERT tower of BiomedCLIP. ``forward(ids [K, L], attn_mask
    [K, L] | None, context [n_ctx, hidden] | None) -> [K, proj_dim]``. The
    context goes in after [CLS] and extends the sequence to L + n_ctx (no
    cut, unlike the CLIP tower); its mask is [mask[CLS], ones(n_ctx),
    mask[1:]]. Word + position + token-type-0
    embeddings (valid token i reads position row i + ``position_offset``, 2
    for the roberta family, capped so the rows stay in the table),
    ``embeddings_ln``, the post-LN layers under an additive
    -inf mask over the keys, the pooler (``pooler_type``, a ``POOLERS`` key;
    default the [CLS] last hidden state), then a bias-free GELU MLP
    hidden -> (hidden + proj_dim) // 2 -> proj_dim."""

    def __init__(self, context_length: int = 256, vocab_size: int = 30522, hidden: int = 768,
                 heads: int = 12, layers: int = 12, proj_dim: int = 512,
                 max_position: int = 512, pooler_type: str = "cls_last_hidden_state_pooler",
                 ln_eps: float = 1e-12, position_offset: int = 0):
        super().__init__()
        if pooler_type not in POOLERS:
            raise ValueError(f"unknown pooler_type {pooler_type!r}; valid: {sorted(POOLERS)}")
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.max_position = max_position
        self.pooler_type = pooler_type
        self.position_offset = position_offset
        self.word_embeddings = nn.Embedding(vocab_size, hidden)
        self.position_embeddings = nn.Parameter(torch.zeros(max_position, hidden))
        self.token_type_embeddings = nn.Parameter(torch.zeros(2, hidden))
        self.embeddings_ln = nn.LayerNorm(hidden, eps=ln_eps)
        for i in range(layers):
            self.add_module(f"layer_{i}", PostLNBertLayer(hidden, heads, ln_eps=ln_eps))
        self.proj_fc1 = nn.Linear(hidden, (hidden + proj_dim) // 2, bias=False)
        self.proj_fc2 = nn.Linear((hidden + proj_dim) // 2, proj_dim, bias=False)

    def forward(self, ids: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None):
        K, L = ids.shape
        if attn_mask is None:
            attn_mask = torch.ones(K, L, dtype=torch.int32, device=ids.device)
        tok = self.word_embeddings(ids.long()).to(compute_dtype(self.word_embeddings))
        if context is not None:
            n_ctx = context.shape[0]
            ctx = context[None].expand(K, n_ctx, self.hidden).to(tok.dtype)
            x = torch.cat([tok[:, :1], ctx, tok[:, 1:]], dim=1)
            mask = torch.cat([attn_mask[:, :1], attn_mask.new_ones(K, n_ctx),
                              attn_mask[:, 1:]], dim=1)
        else:
            x, mask = tok, attn_mask
        off = min(self.position_offset, self.max_position - x.shape[1])
        x = (x + self.position_embeddings[off: off + x.shape[1]].to(x.dtype)[None]
             + self.token_type_embeddings[0].to(x.dtype)[None, None])
        x = layer_norm(self.embeddings_ln, x)
        add_mask = torch.zeros(mask.shape, dtype=torch.float32, device=ids.device) \
            .masked_fill(mask <= 0, float("-inf"))[:, None, :]
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, mask=add_mask)
        pooled = POOLERS[self.pooler_type](x, mask)
        return dense(self.proj_fc2, exact_gelu(dense(self.proj_fc1, pooled)))


def build_text_encoder(embed_dim: int = 512, tiny: bool = False, clip_type: str = "CLIP"):
    """The text tower of ``CLIP_Type`` (``"CLIP"`` or ``"BiomedCLIP"``) at
    full size or the ``tiny`` test size of the JAX package's
    ``build_text_encoder``. Returns (module, token_embed_dim)."""
    if clip_type == "BiomedCLIP":
        if tiny:
            return HFContextTextEncoder(hidden=48, heads=4, layers=2, proj_dim=embed_dim,
                                        vocab_size=512, context_length=32,
                                        max_position=64), 48
        return HFContextTextEncoder(proj_dim=embed_dim), 768
    if clip_type != "CLIP":
        raise ValueError(f"unknown CLIP_Type {clip_type!r} (CLIP or BiomedCLIP)")
    if tiny:
        return CLIPTextContextEncoder(width=48, heads=4, layers=2, embed_dim=embed_dim,
                                      vocab_size=512, context_length=16), 48
    return CLIPTextContextEncoder(embed_dim=embed_dim), 512


def read_state_dict(checkpoint_path_or_sd):
    """A torch checkpoint's state dict: the mapping itself, or read from a
    path (a torch.jit archive, as OpenAI ships, or a saved state dict,
    possibly under ``"state_dict"``)."""
    if not isinstance(checkpoint_path_or_sd, (str, os.PathLike)):
        return checkpoint_path_or_sd
    if not os.path.isfile(checkpoint_path_or_sd):
        raise FileNotFoundError(checkpoint_path_or_sd)
    try:
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
    sd = read_state_dict(checkpoint_path_or_sd)

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


def load_torch_bert_weights(encoder: HFContextTextEncoder, checkpoint_path_or_sd,
                            prefix: str = "text.") -> HFContextTextEncoder:
    """Fill ``encoder`` in place from a BiomedCLIP (open_clip) or HF BERT
    state dict (a path or the dict itself): ``<prefix>transformer.
    embeddings.*`` (a position table of another length is linearly
    resampled, a single token-type row, as roberta ships, is padded with
    zeros), ``encoder.layer.{i}.*`` onto ``layer_{i}`` (query/key/value,
    attention output dense and LayerNorm, intermediate and output dense and
    LayerNorm) and the projection MLP ``<prefix>proj.0``/``proj.2``. Keys
    the checkpoint lacks keep their values."""
    sd = read_state_dict(checkpoint_path_or_sd)
    P = prefix + "transformer."

    def get(key):
        return torch.as_tensor(sd[key]).detach().float().cpu() if key in sd else None

    def put(param, value):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint gives shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    with torch.no_grad():
        w = get(P + "embeddings.word_embeddings.weight")
        if w is not None:
            put(encoder.word_embeddings.weight, w)
        pos = get(P + "embeddings.position_embeddings.weight")
        if pos is not None:
            put(encoder.position_embeddings,
                resize_text_pos_embed(pos, encoder.position_embeddings.shape[0]))
        tt = get(P + "embeddings.token_type_embeddings.weight")
        if tt is not None:
            want = encoder.token_type_embeddings.shape[0]
            if tt.shape[0] < want:
                tt = torch.cat([tt, tt.new_zeros(want - tt.shape[0], tt.shape[1])])
            put(encoder.token_type_embeddings, tt)
        if get(P + "embeddings.LayerNorm.weight") is not None:
            put(encoder.embeddings_ln.weight, get(P + "embeddings.LayerNorm.weight"))
            put(encoder.embeddings_ln.bias, get(P + "embeddings.LayerNorm.bias"))
        for i in range(encoder.layers):
            R = P + f"encoder.layer.{i}."
            blk = getattr(encoder, f"layer_{i}")
            for hf, mod in (("attention.self.query", blk.q_proj),
                            ("attention.self.key", blk.k_proj),
                            ("attention.self.value", blk.v_proj),
                            ("attention.output.dense", blk.out_proj),
                            ("intermediate.dense", blk.fc), ("output.dense", blk.proj),
                            ("attention.output.LayerNorm", blk.attn_ln),
                            ("output.LayerNorm", blk.ffn_ln)):
                w = get(R + hf + ".weight")
                if w is not None:
                    put(mod.weight, w)
                    put(mod.bias, get(R + hf + ".bias"))
        for key, lin in (("proj.0.weight", encoder.proj_fc1), ("proj.2.weight", encoder.proj_fc2)):
            w = get(prefix + key)
            if w is not None:
                put(lin.weight, w)
    return encoder
