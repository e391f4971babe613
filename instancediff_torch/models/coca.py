"""CoCa, the contrastive captioner (port of ``instancediff_tpu/models/coca.py``):
CLIP towers plus a causal multimodal text decoder with per-layer
cross-attention over attention-pooled image tokens, fixed-shape captioning
(``generate``: top-k or top-p sampling; ``generate_beamsearch``) and the
open_clip checkpoint loader ``load_torch_coca_weights``.

Module and parameter names are the flax modules' (``visual``, ``text``,
``text_decoder``, ``block_{i}``, ``cross_{i}``, ``attn_pool``, ...), so
``utils/convert.load_flax_params`` fills a ``CoCa`` from JAX's tree. Every
unmasked attention runs on ``ops/flash_attention.multi_head_flash`` (the
kernel on CUDA, its plain version on the CPU): the vision tower's
self-attention, the attentional pooler's 256 queries over the image tokens
and the decoder's cross-attention over the pooled tokens. The causal
self-attention of the text tower and the decoder is masked and stays on
``ops/attention.py``'s plain matmuls, as in JAX.

Captioning runs a fixed number of steps, as JAX's ``lax.scan`` does: each
step decodes the whole ``[B, seq_len]`` buffer and reads one position (no
key-value cache). Sampling is JAX's ``categorical``, the argmax of the
logits plus Gumbel draws; the draws come from ``rng``, a ``torch.Generator``
or an iterator of the draws themselves (``ops/attention.draw``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import draw
from ..ops.flash_attention import multi_head_flash
from .clip_vit import OPENAI_MEAN, OPENAI_STD
from .layers import cast_compute_, compute_dtype, conv_same, dense, layer_norm
from . import vision_towers
from .text_encoder import TransformerBlock, exact_gelu, quick_gelu

__all__ = ["AttentionalPooler", "CrossAttentionBlock", "MultimodalDecoder", "CoCaTextTower",
           "CoCaVisionTower", "CoCa", "build_coca", "generate", "generate_beamsearch",
           "load_torch_coca_weights", "SOT_ID", "EOS_ID"]

NEG_INF = -1e9  # the additive mask's -inf stand-in, as JAX's (finite: softmax stays NaN-free)


def _act(act: str):
    if act not in ("quick_gelu", "gelu"):
        raise ValueError(f"unknown act {act!r} (quick_gelu or gelu)")
    return quick_gelu if act == "quick_gelu" else exact_gelu


def _causal(L: int, device) -> torch.Tensor:
    return torch.full((L, L), NEG_INF, device=device).triu(1)


class AttentionalPooler(nn.Module):
    """Learnable-query cross-attention pooling: ``forward(x [B, N,
    context_dim]) -> [B, n_queries, d_model]``; ``query`` through ``ln_q``,
    the tokens through ``ln_k``, k and v projected from ``context_dim``."""

    def __init__(self, d_model: int, context_dim: int, n_head: int = 8, n_queries: int = 256):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Parameter(torch.zeros(n_queries, d_model))
        self.ln_q = nn.LayerNorm(d_model, eps=1e-5)
        self.ln_k = nn.LayerNorm(context_dim, eps=1e-5)
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(context_dim, d_model)
        self.v_proj = nn.Linear(context_dim, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x):
        qh = dense(self.q_proj, layer_norm(self.ln_q, self.query))
        k = layer_norm(self.ln_k, x)
        out = multi_head_flash(qh.expand(x.shape[0], *qh.shape), dense(self.k_proj, k),
                               dense(self.v_proj, k), self.n_head)
        return dense(self.out_proj, out)


class CrossAttentionBlock(nn.Module):
    """Pre-LN residual cross-attention block: ``x + out_proj(attn(ln_1(x),
    ln_1_kv(kv)))``, then ``x + proj(act(fc(ln_2(x))))``; ``act`` is the
    exact erf GELU (open_clip's ``nn.GELU``) or ``"quick_gelu"``."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, act: str = "gelu"):
        super().__init__()
        self.heads = heads
        self.act = _act(act)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.ln_1_kv = nn.LayerNorm(width, eps=1e-5)
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.fc = nn.Linear(width, int(width * mlp_ratio))
        self.proj = nn.Linear(int(width * mlp_ratio), width)

    def forward(self, x, kv):
        h = layer_norm(self.ln_1, x)
        hk = layer_norm(self.ln_1_kv, kv)
        attn = multi_head_flash(dense(self.q_proj, h), dense(self.k_proj, hk),
                                dense(self.v_proj, hk), self.heads)
        x = x + dense(self.out_proj, attn)
        h = self.act(dense(self.fc, layer_norm(self.ln_2, x)))
        return x + dense(self.proj, h)


class MultimodalDecoder(nn.Module):
    """Per layer a causal self-attention ``TransformerBlock`` then a
    ``CrossAttentionBlock`` over the image tokens; ``ln_final`` and the
    bias-free ``text_projection`` to the vocabulary: ``forward(image_embs
    [B, M, width], text_embs [B, L, width]) -> logits [B, L, vocab]``."""

    def __init__(self, width: int, heads: int, layers: int, vocab_size: int,
                 mlp_ratio: float = 4.0, act: str = "gelu"):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, mlp_ratio=mlp_ratio,
                                                           act=act))
            self.add_module(f"cross_{i}", CrossAttentionBlock(width, heads, mlp_ratio, act))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Linear(width, vocab_size, bias=False)

    def forward(self, image_embs, text_embs):
        causal = _causal(text_embs.shape[1], text_embs.device)[None]
        x = text_embs
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, mask=causal)
            x = getattr(self, f"cross_{i}")(x, image_embs)
        return dense(self.text_projection, layer_norm(self.ln_final, x))


class CoCaTextTower(nn.Module):
    """The text tower with an appended CLS token: ``forward(ids [B, L]) ->
    (latent [B, embed_dim], token embeddings [B, L, width])``. The mask is
    causal plus the reference's CLS mask: the pad bit of token j sits on the
    CLS query row only, at key j + 1 (key 0 always kept). The latent is
    ``text_projection(ln_final(x[:, -1]))``; the token embeddings (without
    the CLS position, not normalised) feed the decoder."""

    def __init__(self, vocab_size: int, context_length: int = 76, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512, pad_id: int = 0,
                 act: str = "gelu"):
        super().__init__()
        self.width = width
        self.layers = layers
        self.pad_id = pad_id
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.cls_emb = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(context_length + 1, width))
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, act=act))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Linear(width, embed_dim, bias=False)

    def forward(self, ids):
        B, L = ids.shape
        tok = self.token_embedding(ids.long()).to(compute_dtype(self.token_embedding))
        x = torch.cat([tok, self.cls_emb.to(tok.dtype).expand(B, 1, self.width)], dim=1)
        x = x + self.positional_embedding[: L + 1].to(x.dtype)[None]
        keep = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=ids.device),
                          ids != self.pad_id], dim=1)
        mask = _causal(L + 1, ids.device).repeat(B, 1, 1)
        mask[:, -1] += torch.where(keep, 0.0, NEG_INF)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, mask=mask)
        latent = dense(self.text_projection, layer_norm(self.ln_final, x[:, -1]))
        return latent, x[:, :-1]


class CoCaVisionTower(nn.Module):
    """The ViT with attentional pooling: ``forward(images [B, H, W, C in
    [-1, 1]]) -> (latent [B, embed_dim], tokens [B, n_queries - 1,
    embed_dim])``. [-1, 1] -> [0, 1], one channel repeated to three, OpenAI
    mean/std, the stride-``patch_size`` patch conv, the class token first,
    ``pos_embed``, ``ln_pre``, the unmasked blocks, the pooler, ``ln_post``;
    query 0 -> ``proj`` is the latent, queries 1.. the decoder's memory."""

    def __init__(self, image_size: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, embed_dim: int = 512, n_queries: int = 256,
                 attn_pooler_heads: int = 8, act: str = "gelu"):
        super().__init__()
        self.patch_size = patch_size
        self.width = width
        self.layers = layers
        grid = -(-image_size // patch_size)
        self.patch_embed = nn.Conv2d(3, width, patch_size, stride=patch_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(width, heads, act=act))
        self.attn_pool = AttentionalPooler(embed_dim, width, n_head=attn_pooler_heads,
                                           n_queries=n_queries)
        self.ln_post = nn.LayerNorm(embed_dim, eps=1e-5)
        self.proj = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, images):
        B, H, W, C = images.shape
        x01 = (images + 1.0) / 2.0
        if C == 1:
            x01 = x01.expand(B, H, W, 3)
        mean = torch.tensor(OPENAI_MEAN, dtype=x01.dtype, device=x01.device)
        std = torch.tensor(OPENAI_STD, dtype=x01.dtype, device=x01.device)
        x = conv_same((x01 - mean) / std, self.patch_embed, stride=self.patch_size)
        x = x.reshape(B, -1, self.width)
        x = torch.cat([self.class_token.to(x.dtype).expand(B, 1, self.width), x], dim=1)
        x = layer_norm(self.ln_pre, x + self.pos_embed.to(x.dtype)[None])
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        x = layer_norm(self.ln_post, self.attn_pool(x))
        return dense(self.proj, x[:, 0]), x[:, 1:]


class CoCa(nn.Module):
    """The contrastive captioner, with JAX's fields. ``forward(images, ids=None,
    image_latent=None, image_embs=None)`` returns ``{"image_features",
    "text_features", "logits", "labels", "logit_scale"}``, or
    ``{"image_features", "image_embs"}`` without ``ids``; ``encode_image``,
    ``encode_text`` (latents L2-normalised by default) and ``decode``
    (logits [B, L, vocab] of ``ids`` given the pooled image tokens). A
    ``dtype`` other than float32 computes in it with float32 parameters
    (``layers.cast_compute_(master=True)``), norms in float32, as JAX's."""

    def __init__(self, embed_dim: int = 512, vocab_size: int = 49408, context_length: int = 76,
                 text_width: int = 512, text_heads: int = 8, text_layers: int = 12,
                 mm_width: int = 512, mm_heads: int = 8, mm_layers: int = 12,
                 image_size: int = 224, patch_size: int = 32, vision_width: int = 768,
                 vision_layers: int = 12, vision_heads: int = 12, n_queries: int = 256,
                 pad_id: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.vocab_size = vocab_size
        self.n_queries = n_queries
        self.pad_id = pad_id
        self.dtype = dtype
        self.visual = CoCaVisionTower(image_size, patch_size, vision_width, vision_layers,
                                      vision_heads, embed_dim, n_queries)
        self.text = CoCaTextTower(vocab_size, context_length, text_width, text_heads,
                                  text_layers, embed_dim, pad_id)
        self.text_decoder = MultimodalDecoder(mm_width, mm_heads, mm_layers, vocab_size)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        if dtype != torch.float32:
            cast_compute_(self, dtype, master=True)

    @staticmethod
    def _normalize(x):
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-8)

    def encode_image(self, images, normalize: bool = True):
        latent, embs = self.visual(images)
        return (self._normalize(latent) if normalize else latent), embs

    def encode_text(self, ids, normalize: bool = True):
        latent, tokens = self.text(ids)
        return (self._normalize(latent) if normalize else latent), tokens

    def decode(self, image_embs, ids):
        _, token_embs = self.text(ids)
        return self.text_decoder(image_embs, token_embs)

    def forward(self, images, ids=None, image_latent=None, image_embs=None):
        if image_latent is None or image_embs is None:
            image_latent, image_embs = self.encode_image(images)
        if ids is None:
            return {"image_features": image_latent, "image_embs": image_embs}
        text_latent, token_embs = self.encode_text(ids)
        logits = self.text_decoder(image_embs, token_embs)
        return {"image_features": image_latent, "text_features": text_latent,
                "logits": logits, "labels": ids[:, -token_embs.shape[1]:],
                "logit_scale": self.logit_scale.exp()}


def build_coca(tiny: bool = False, dtype: torch.dtype = torch.float32, device="cuda",
               **kwargs) -> CoCa:
    """A ``CoCa`` on ``device`` at JAX's defaults (coca_ViT-B-32), or every
    tower shrunk for tests with ``tiny``."""
    if tiny:
        kwargs = dict(embed_dim=16, vocab_size=64, context_length=12, text_width=16,
                      text_heads=2, text_layers=2, mm_width=16, mm_heads=2, mm_layers=2,
                      image_size=16, patch_size=8, vision_width=16, vision_layers=2,
                      vision_heads=2, n_queries=5, **kwargs)
    return CoCa(dtype=dtype, **kwargs).to(device)


# ---------------------------------------------------------------- generation

SOT_ID = 49406  # the reference's defaults
EOS_ID = 49407


def _process_logits(logits, out, cur_len: int, eos_id: int, min_seq_len: int,
                    repetition_penalty: float):
    """The MinLength and RepetitionPenalty processors (HF semantics: the
    scores of tokens already in ``out[:, :cur_len]`` divided by the penalty
    where positive, multiplied where negative; EOS barred before
    ``min_seq_len``)."""
    if repetition_penalty != 1.0:
        seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, out[:, :cur_len].long(),
                                                                   True)
        pen = torch.where(logits > 0, logits / repetition_penalty, logits * repetition_penalty)
        logits = torch.where(seen, pen, logits)
    if cur_len < min_seq_len and eos_id < logits.shape[-1]:
        logits = logits.clone()
        logits[:, eos_id] = NEG_INF
    return logits


def _warp_logits(logits, generation_type: str, top_k: int, top_p: float):
    """The TopK and TopP warpers: logits outside the top ``top_k``, or outside
    the smallest set whose probability before its last member is at most
    ``top_p``, set to ``NEG_INF``."""
    if generation_type == "top_k":
        kth = torch.sort(logits, dim=-1).values[:, -max(int(top_k), 1)][:, None]
        return torch.where(logits < kth, NEG_INF, logits)
    if generation_type == "top_p":
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        thresh = torch.where(cum - probs > top_p, NEG_INF, sorted_logits).amin(dim=-1,
                                                                               keepdim=True)
        return torch.where(logits < thresh, NEG_INF, logits)
    raise ValueError(f"generation_type {generation_type!r} not in "
                     "{'top_k','top_p','beam_search'}")


def _gumbel(rng, shape, device) -> torch.Tensor:
    """Standard Gumbel draws: ``-log(-log(u))`` of uniform draws from a
    ``torch.Generator`` (u >= the smallest normal float32), or the next
    draws of an iterator of Gumbel draws."""
    if isinstance(rng, torch.Generator):
        u = draw(rng, shape, torch.float32, device).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))
    return draw(rng, shape, torch.float32, device)


@torch.no_grad()
def generate(model: CoCa, images, rng=None, seq_len: int = 30, generation_type: str = "top_k",
             top_k: int = 1, top_p: float = 0.1, temperature: float = 1.0,
             min_seq_len: int = 5, repetition_penalty: float = 1.0,
             sot_token_id: int = SOT_ID, eos_token_id: int = EOS_ID,
             pad_token_id: Optional[int] = None, num_beams: int = 6,
             num_beam_groups: int = 3) -> torch.Tensor:
    """Caption ``images`` [B, H, W, C] -> token ids [B, seq_len] (int32), a
    fixed number of steps as JAX's ``generate``: SOT first; at each position
    i = 1 .. seq_len - 1 the logits of position i - 1 through the processors
    and the warper, then ``argmax(logits / temperature + gumbel)`` with the
    draws from ``rng``; EOS forced at the last position; after a sampled
    EOS or PAD a row takes PAD. ``"beam_search"`` calls
    ``generate_beamsearch``."""
    if generation_type == "beam_search":
        return generate_beamsearch(
            model, images, seq_len=seq_len, num_beams=num_beams,
            num_beam_groups=num_beam_groups, min_seq_len=min_seq_len,
            sot_token_id=sot_token_id, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, repetition_penalty=repetition_penalty)
    if rng is None:
        raise ValueError("generate draws its samples from rng: a torch.Generator or an "
                         "iterator of Gumbel draws")
    pad_id = model.pad_id if pad_token_id is None else pad_token_id
    B = images.shape[0]
    _, image_embs = model.encode_image(images)
    out = torch.full((B, seq_len), pad_id, dtype=torch.int32, device=image_embs.device)
    out[:, 0] = sot_token_id
    finished = torch.zeros(B, dtype=torch.bool, device=out.device)
    for i in range(1, seq_len):
        logits = model.decode(image_embs, out)[:, i - 1].float()
        logits = _process_logits(logits, out, i, eos_token_id, min_seq_len, repetition_penalty)
        logits = _warp_logits(logits, generation_type, top_k, top_p)
        sample = (logits / temperature + _gumbel(rng, logits.shape, logits.device)).argmax(-1)
        if i == seq_len - 1:
            sample = torch.full_like(sample, eos_token_id)
        sample = torch.where(finished, pad_id, sample).to(torch.int32)
        out[:, i] = sample
        finished = finished | (sample == eos_token_id) | (sample == pad_id)
    return out


def _top_k_lowest_first(x, k: int):
    """(values, indices) of the ``k`` largest along the last axis, equal
    values in index order, as ``lax.top_k`` gives them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def generate_beamsearch(model: CoCa, images, seq_len: int = 30, num_beams: int = 6,
                        num_beam_groups: int = 3, min_seq_len: int = 5,
                        sot_token_id: int = SOT_ID, eos_token_id: int = EOS_ID,
                        pad_token_id: Optional[int] = None,
                        repetition_penalty: float = 1.0) -> torch.Tensor:
    """Fixed-length beam search -> token ids [B, seq_len] (int32), JAX's
    ``generate_beamsearch``: ``num_beam_groups`` independent searches of
    ``num_beams // num_beam_groups`` beams (beam 0 of each starts at score 0,
    the others at ``NEG_INF``); a finished beam continues with PAD at an
    unchanged score; EOS forced at the last position; the best beam over
    groups and beams by its score over its length up to its first EOS."""
    if num_beams % num_beam_groups:
        raise ValueError(f"num_beams {num_beams} is not a multiple of num_beam_groups "
                         f"{num_beam_groups}")
    pad_id = model.pad_id if pad_token_id is None else pad_token_id
    G, Bm = num_beam_groups, num_beams // num_beam_groups
    B = images.shape[0]
    _, image_embs = model.encode_image(images)
    M, D = image_embs.shape[1], image_embs.shape[2]
    dev = image_embs.device
    R = B * G * Bm
    embs = image_embs[:, None].expand(B, G * Bm, M, D).reshape(R, M, D)
    out = torch.full((R, seq_len), pad_id, dtype=torch.int32, device=dev)
    out[:, 0] = sot_token_id
    scores = torch.where(torch.arange(Bm, device=dev) == 0, 0.0, NEG_INF).repeat(B, G, 1)
    finished = torch.zeros(R, dtype=torch.bool, device=dev)
    length = torch.full((R,), seq_len, dtype=torch.int32, device=dev)
    base = (torch.arange(B, device=dev)[:, None, None] * (G * Bm)
            + torch.arange(G, device=dev)[None, :, None] * Bm)
    for i in range(1, seq_len):
        logits = model.decode(embs, out)[:, i - 1].float()
        logits = _process_logits(logits, out, i, eos_token_id, min_seq_len, repetition_penalty)
        logp = torch.log_softmax(logits, dim=-1)
        V = logp.shape[-1]
        pad_only = torch.where(torch.arange(V, device=dev)[None] == pad_id, 0.0, NEG_INF)
        logp = torch.where(finished[:, None], pad_only, logp).reshape(B, G, Bm, V)
        cand = scores[..., None] + logp
        scores, top_i = _top_k_lowest_first(cand.reshape(B, G, Bm * V), Bm)
        parent = (base + top_i // V).reshape(-1)
        out, finished, length = out[parent], finished[parent], length[parent]
        tok = (top_i % V).reshape(-1).to(torch.int32)
        if i == seq_len - 1:
            tok = torch.where(finished, pad_id, eos_token_id).to(torch.int32)
        tok = torch.where(finished, pad_id, tok).to(torch.int32)
        out[:, i] = tok
        now_finished = finished | (tok == eos_token_id)
        length = torch.where(now_finished & ~finished, i + 1, length).to(torch.int32)
        finished = now_finished
    norm = scores.reshape(B, G * Bm) / length.reshape(B, G * Bm)
    best = norm.argmax(dim=-1)
    return out.reshape(B, G * Bm, seq_len)[torch.arange(B, device=dev), best]


# ---------------------------------------------------------------- weight conversion


class _Filler(vision_towers._Filler):
    """``vision_towers._Filler`` over the keys present only, as JAX's
    loader maps them."""

    def linear(self, lin, prefix):
        if prefix + ".weight" in self:
            self.put(lin.weight, self.get(prefix + ".weight"))
            self.put(lin.bias, self.get(prefix + ".bias"))

    def norm(self, ln, prefix):
        self.linear(ln, prefix)

    def resblock(self, blk, prefix, cross: bool = False):
        """A torch ``ResidualAttentionBlock``: fused ``in_proj`` rows q | k |
        v, ``out_proj``, the MLP, the norms (``ln_1_kv`` too when ``cross``)."""
        if prefix + "attn.in_proj_weight" in self:
            w, b = self.get(prefix + "attn.in_proj_weight"), self.get(prefix + "attn.in_proj_bias")
            C = w.shape[1]
            for j, lin in enumerate((blk.q_proj, blk.k_proj, blk.v_proj)):
                self.put(lin.weight, w[j * C:(j + 1) * C])
                self.put(lin.bias, b[j * C:(j + 1) * C])
        for t_name, lin in (("attn.out_proj", blk.out_proj), ("mlp.c_fc", blk.fc),
                            ("mlp.c_proj", blk.proj)):
            self.linear(lin, prefix + t_name)
        for ln in ("ln_1", "ln_1_kv", "ln_2") if cross else ("ln_1", "ln_2"):
            self.norm(getattr(blk, ln), prefix + ln)

    def attn_pool(self, pool, prefix):
        """A torch ``AttentionalPooler``: ``query``, ``ln_q``/``ln_k`` and its
        ``nn.MultiheadAttention``, whose q/k/v weights are separate
        (``q_proj_weight`` ..., where kdim differs from the width; zero bias
        when ``in_proj_bias`` is absent) or fused (``in_proj_weight``)."""
        if prefix + "query" in self:
            self.put(pool.query, self.get(prefix + "query"))
        self.norm(pool.ln_q, prefix + "ln_q")
        self.norm(pool.ln_k, prefix + "ln_k")
        A = prefix + "attn."
        lins = (pool.q_proj, pool.k_proj, pool.v_proj)
        if A + "q_proj_weight" in self:
            ws = [self.get(A + n) for n in ("q_proj_weight", "k_proj_weight", "v_proj_weight")]
            E = ws[0].shape[0]
            b = self.get(A + "in_proj_bias") if A + "in_proj_bias" in self \
                else torch.zeros(3 * E)
            for j, (w, lin) in enumerate(zip(ws, lins)):
                self.put(lin.weight, w)
                self.put(lin.bias, b[j * E:(j + 1) * E])
        elif A + "in_proj_weight" in self:
            w, b = self.get(A + "in_proj_weight"), self.get(A + "in_proj_bias")
            E = w.shape[1]
            for j, lin in enumerate(lins):
                self.put(lin.weight, w[j * E:(j + 1) * E])
                self.put(lin.bias, b[j * E:(j + 1) * E])
        self.linear(pool.out_proj, A + "out_proj")


def load_torch_coca_weights(coca: CoCa, checkpoint_path_or_sd) -> CoCa:
    """Fill ``coca`` in place from an open_clip CoCa checkpoint (coca_ViT-B-32
    family; a path, possibly holding ``"state_dict"``, or the mapping; a
    ``module.`` prefix is stripped): ``visual.conv1`` (a bias-free conv
    zeroes the tower's bias), ``class_embedding``, ``positional_embedding``,
    ``ln_pre``/``ln_post``, ``proj``, ``transformer.resblocks.*``,
    ``attn_pool``; ``text.*`` with ``cls_emb``; ``text_decoder.resblocks.*``
    and ``cross_attn.*``, ``ln_final``, ``text_projection``; ``logit_scale``.
    Keys the checkpoint lacks keep their values. Returns ``coca``."""
    fill = _Filler(checkpoint_path_or_sd, prefix="module.")
    vis, txt, dec = coca.visual, coca.text, coca.text_decoder
    with torch.no_grad():
        if "visual.conv1.weight" in fill:
            fill.put(vis.patch_embed.weight, fill.get("visual.conv1.weight"))
            fill.put(vis.patch_embed.bias, fill.get("visual.conv1.bias")
                     if "visual.conv1.bias" in fill else torch.zeros_like(vis.patch_embed.bias))
        if "visual.class_embedding" in fill:
            fill.put(vis.class_token, fill.get("visual.class_embedding").reshape(1, 1, -1))
        if "visual.positional_embedding" in fill:
            fill.put(vis.pos_embed, fill.get("visual.positional_embedding"))
        fill.norm(vis.ln_pre, "visual.ln_pre")
        fill.norm(vis.ln_post, "visual.ln_post")
        if "visual.proj" in fill:  # pooled @ proj: a bias-free Linear
            fill.put(vis.proj.weight, fill.get("visual.proj").T)
        for i in range(vis.layers):
            fill.resblock(getattr(vis, f"block_{i}"), f"visual.transformer.resblocks.{i}.")
        fill.attn_pool(vis.attn_pool, "visual.attn_pool.")

        if "text.token_embedding.weight" in fill:
            fill.put(txt.token_embedding.weight, fill.get("text.token_embedding.weight"))
        for name in ("cls_emb", "positional_embedding"):
            if f"text.{name}" in fill:
                fill.put(getattr(txt, name), fill.get(f"text.{name}"))
        fill.norm(txt.ln_final, "text.ln_final")
        if "text.text_projection" in fill:
            fill.put(txt.text_projection.weight, fill.get("text.text_projection").T)
        for i in range(txt.layers):
            fill.resblock(getattr(txt, f"block_{i}"), f"text.transformer.resblocks.{i}.")

        fill.norm(dec.ln_final, "text_decoder.ln_final")
        if "text_decoder.text_projection" in fill:
            fill.put(dec.text_projection.weight, fill.get("text_decoder.text_projection").T)
        for i in range(dec.layers):
            fill.resblock(getattr(dec, f"block_{i}"), f"text_decoder.resblocks.{i}.")
            fill.resblock(getattr(dec, f"cross_{i}"), f"text_decoder.cross_attn.{i}.", cross=True)

        if "logit_scale" in fill:
            fill.put(coca.logit_scale, fill.get("logit_scale").reshape(()))
    return coca
