"""BiomedCLIP, the contrastive image/text model (port of
``instancediff_tpu/models/biomedclip.py``): the ViT-B/16 image tower
(``clip_vit.py``), the PubMedBERT text tower (``text_encoder.
HFContextTextEncoder``) with its WordPiece tokenizer, L2-normalised
``encode_image`` / ``encode_text`` and logits at ``exp(logit_scale)``. The
reference embeds each degraded image offline with it
(``tools/precompute_embeddings.py``). ``clip_type="CLIP"`` is the OpenAI
flavour of the same wrapper (the OpenAI ViT, the CLIP text tower and its
BPE tokenizer), and ``vision_tower="resnet"`` swaps the ViT for the RN
family's ``vision_towers.ModifiedResNet``: what ``openai.load_openai_model``
builds.

The JAX wrapper draws its towers from ``seed`` (or loads an open_clip
checkpoint's visual tower over the draw). The port draws nothing: its
weights come from an open_clip state dict (``checkpoint_path``: the visual
tower, and the text tower where the dict has ``text.*`` keys) or from the
flax trees ``tools/export_image_params.py --biomedclip`` writes with JAX
(``params``, ``text_params``), and ``get_BiomedCLIP`` refuses with neither.
``encode_text`` refuses a text tower that no weights reached.

``precision`` takes the reference's strings (``PRECISIONS``): fp32; bf16 and
fp16 (16-bit compute, float32 parameters); pure_bf16 and pure_fp16 (the
parameters cast too, the norms' rounded values used in float32). The image
tower's attention runs the flash kernel in the compute dtype (fp16 on its
fp16 instantiation)."""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..utils.checkpoint import load_pytree
from ..utils.convert import load_flax_params
from .clip_vit import CLIPVisionTower, load_torch_clip_vision_weights
from .layers import cast_compute_
from .text_encoder import (CLIPTextContextEncoder, HFContextTextEncoder, load_torch_bert_weights,
                           load_torch_clip_text_weights, read_state_dict)
from .tokenizer import BertWordPieceTokenizer, ClipBPETokenizer
from .vision_towers import ModifiedResNet, load_torch_clip_resnet_weights

PRECISIONS = ("fp32", "fp16", "bf16", "pure_fp16", "pure_bf16")


def get_cast_dtype(precision: str):
    """The weights' cast dtype of a precision string: bfloat16 for 'bf16',
    float16 for 'fp16', else None ('pure_*' cast the whole model instead)."""
    return {"bf16": torch.bfloat16, "fp16": torch.float16}.get(precision)


def get_input_dtype(precision: str):
    """The input pixels' dtype: bfloat16 for bf16 / pure_bf16, float16 for
    fp16 / pure_fp16, else None (float32)."""
    if precision in ("bf16", "pure_bf16"):
        return torch.bfloat16
    if precision in ("fp16", "pure_fp16"):
        return torch.float16
    return None


def _precision_dtypes(precision):
    """(compute dtype, parameter cast dtype, input dtype), the reference's
    table: fp32 everywhere; fp16 / bf16 compute in the low precision with
    float32 parameters (norms in float32); pure_* cast the parameters
    too."""
    if precision is None or precision == "fp32":
        return torch.float32, None, None
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; choose from {PRECISIONS}")
    low = torch.bfloat16 if "bf16" in precision else torch.float16
    return low, (low if precision.startswith("pure_") else None), get_input_dtype(precision)


def _tree(params):
    return load_pytree(params) if isinstance(params, (str, os.PathLike)) else params


class BiomedCLIP:
    """``encode_image(images [B,H,W,1|3] in [-1,1]) -> [B, E]`` and
    ``encode_text(list of str) -> [K, E]``, both L2-normalised; calling it
    gives the image-text logits. ``clip_type`` "BiomedCLIP": the timm ViT
    (exact GELU, eps 1e-6, no ``ln_pre``), PubMedBERT and WordPiece;
    "CLIP": the OpenAI ViT (QuickGELU, eps 1e-5, ``ln_pre``), the CLIP text
    tower and the BPE tokenizer (``vocab_path``: the vocab.txt or the bpe
    merges file, else the hash fallback). ``vision_tower`` "resnet": the RN
    family (``rn_layers``, ``rn_width``; attention-pool heads ``rn_width *
    32 // 64``; tiny: (1, 1, 1, 1) and 8). ``precision``: one of
    ``PRECISIONS``."""

    def __init__(self, clip_type="BiomedCLIP", embed_dim=512, vocab_path=None,
                 checkpoint_path=None, params=None, text_params=None, tiny=False,
                 vision_tower="vit", rn_layers=(3, 4, 6, 3), rn_width=64, precision=None,
                 device="cuda"):
        if clip_type not in ("BiomedCLIP", "CLIP"):
            raise ValueError(f"unknown clip_type {clip_type!r} (BiomedCLIP or CLIP)")
        if vision_tower not in ("vit", "resnet"):
            raise ValueError(f"unknown vision_tower {vision_tower!r} (vit or resnet)")
        if checkpoint_path is None and params is None:
            raise ValueError(
                "BiomedCLIP needs weights: checkpoint_path (an open_clip state dict) or "
                "params (the visual tower's flax tree, written with JAX by "
                "tools/export_image_params.py --biomedclip); the port draws none")
        compute, param_cast, self.input_dtype = _precision_dtypes(precision)
        self.device = resolve_device(device)
        self.clip_type = clip_type
        self.embed_dim = embed_dim
        self.precision = precision or "fp32"
        res = 32 if tiny else 224
        if vision_tower == "resnet":
            if tiny:
                rn_layers, rn_width = (1, 1, 1, 1), 8
            self.visual = ModifiedResNet(tuple(rn_layers), rn_width, embed_dim,
                                         heads=max(1, rn_width * 32 // 64),
                                         openai_normalize=True, image_size=res)
        else:
            flavour = "openai" if clip_type == "CLIP" else "timm"
            size = (dict(image_size=32, patch_size=8, width=32, layers=2, heads=4) if tiny
                    else {})
            self.visual = CLIPVisionTower(embed_dim=embed_dim, flavour=flavour, **size)
        if clip_type == "BiomedCLIP":
            self.text = (HFContextTextEncoder(hidden=32, heads=4, layers=2, proj_dim=embed_dim,
                                              vocab_size=512, context_length=32,
                                              max_position=64) if tiny
                         else HFContextTextEncoder(proj_dim=embed_dim))
            self.tokenizer = BertWordPieceTokenizer(vocab_path, self.text.context_length,
                                                    self.text.vocab_size)
        else:
            self.text = (CLIPTextContextEncoder(width=32, heads=4, layers=2, embed_dim=embed_dim,
                                                vocab_size=512, context_length=16) if tiny
                         else CLIPTextContextEncoder(embed_dim=embed_dim))
            self.tokenizer = ClipBPETokenizer(vocab_path, self.text.context_length,
                                              self.text.vocab_size)
        self.logit_scale = float(np.log(1 / 0.07))  # open_clip's init
        self.text_loaded = False
        with torch.no_grad():
            if checkpoint_path is not None:
                sd = read_state_dict(checkpoint_path)
                if vision_tower == "resnet":
                    load_torch_clip_resnet_weights(self.visual, sd)
                else:
                    load_torch_clip_vision_weights(self.visual, sd)
                if clip_type == "BiomedCLIP" and \
                        "text.transformer.embeddings.word_embeddings.weight" in sd:
                    load_torch_bert_weights(self.text, sd)
                    self.text_loaded = True
                if clip_type == "CLIP" and "token_embedding.weight" in sd:
                    load_torch_clip_text_weights(self.text, sd)
                    self.text_loaded = True
            if params is not None:
                load_flax_params(self.visual, _tree(params))
            if text_params is not None:
                load_flax_params(self.text, _tree(text_params))
                self.text_loaded = True
        for module in (self.visual, self.text):
            module.to(self.device).eval().requires_grad_(False)
            if param_cast is not None:  # pure_*: the whole model in the low precision,
                module.to(param_cast)  # the norms' rounded values used in float32 as in JAX
                for m in module.modules():
                    if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                        m.float()
            cast_compute_(module, compute, master=param_cast is None)

    @torch.inference_mode()
    def encode_image(self, images, normalize: bool = True) -> torch.Tensor:
        """images: [B,H,W,1|3] in [-1,1] (array or tensor) -> [B, embed_dim]."""
        images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                                 dtype=torch.float32, device=self.device)
        if self.input_dtype is not None:
            images = images.to(self.input_dtype)
        emb = self.visual(images)
        if normalize:
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-8)
        return emb

    @torch.inference_mode()
    def encode_text(self, texts, normalize: bool = True) -> torch.Tensor:
        if not self.text_loaded:
            raise ValueError("the text tower has no weights: pass text_params (written by "
                             "tools/export_image_params.py --biomedclip --text-out) or a "
                             "checkpoint with the text tower's keys")
        if self.clip_type == "BiomedCLIP":
            ids, mask = self.tokenizer(texts)
            emb = self.text(torch.from_numpy(ids).to(self.device),
                            torch.from_numpy(mask).to(self.device), None)
        else:
            emb = self.text(torch.from_numpy(np.asarray(self.tokenizer(texts))).to(self.device),
                            None)
        if normalize:
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-8)
        return emb

    def __call__(self, images, texts) -> torch.Tensor:
        """Image-text logits ``exp(logit_scale) * image_emb @ text_emb.T``."""
        ie, te = self.encode_image(images), self.encode_text(texts)
        return math.exp(self.logit_scale) * ie @ te.T


def get_BiomedCLIP(vocab_path=None, checkpoint_path=None, tiny=False, precision=None,
                   params=None, text_params=None, device="cuda") -> BiomedCLIP:
    """The BiomedCLIP model of the reference's loader, its weights from
    ``checkpoint_path`` or the ``params`` / ``text_params`` trees (paths or
    trees; ``tools/export_image_params.py --biomedclip --seed S`` writes
    those of the JAX loader's draw from ``seed=S``)."""
    return BiomedCLIP(vocab_path=vocab_path,
                      checkpoint_path=checkpoint_path, params=params, text_params=text_params,
                      tiny=tiny, precision=precision, device=device)
