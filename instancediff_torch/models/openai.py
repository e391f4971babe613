"""OpenAI-CLIP checkpoint loading (port of
``instancediff_tpu/models/openai.py``): resolve an OpenAI model name (the
registry's ``openai`` rows, local caches only) or a checkpoint path, read
the state dict or TorchScript archive, and build a ``biomedclip.BiomedCLIP``
with ``clip_type="CLIP"`` whose two towers carry its weights: the ViT, or
the RN family's ``ModifiedResNet`` when the checkpoint has
``visual.layer1.*`` keys (its ``rn_width``, ``rn_layers`` and ``embed_dim``
read from the checkpoint). Returns it with the registry's eval transform.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from ..data.transforms import image_transform
from .biomedclip import BiomedCLIP
from .pretrained import download_pretrained, get_pretrained_cfg, list_pretrained_models_by_tag
from .text_encoder import read_state_dict

__all__ = ["list_openai_models", "load_openai_model"]


def list_openai_models() -> List[str]:
    """The registry's models that carry the 'openai' tag."""
    return list_pretrained_models_by_tag("openai")


def _rn_geometry(sd) -> tuple:
    """(rn_width, rn_layers) of an RN-family visual state dict: the stem's
    first conv has width / 2 filters; stage s has as many blocks as its
    largest block index + 1."""
    width = int(sd["visual.conv1.weight"].shape[0]) * 2
    layers = tuple(1 + max((int(k.split(".")[2]) for k in sd
                            if k.startswith(f"visual.layer{s}.")), default=0)
                   for s in (1, 2, 3, 4))
    return width, layers


def load_openai_model(name: str, vocab_path: Optional[str] = None,
                      cache_dir: Optional[str] = None, embed_dim: int = 512,
                      tiny: bool = False, device="cuda"):
    """Load an OpenAI CLIP by registry name (resolved from local caches,
    ``pretrained.download_pretrained``) or checkpoint path: a TorchScript
    archive, as OpenAI ships, or a ``torch.save``d state dict (read with
    torch's default ``weights_only``; one under ``"state_dict"`` loses its
    ``module.`` prefixes; ``text_encoder.read_state_dict``). Returns
    ``(model, preprocess)``: a ``BiomedCLIP`` (``clip_type="CLIP"``) on
    ``device`` with both towers' weights and ``logit_scale`` from the
    checkpoint (``embed_dim`` read from ``text_projection`` where it has
    one), and the registry's eval transform (224 px, OpenAI mean and std,
    bicubic, shortest side, for a path). ``tiny`` builds the JAX package's
    test sizes. An unknown name raises RuntimeError."""
    cfg = get_pretrained_cfg(name, "openai")
    if cfg:
        model_path = download_pretrained(cfg, cache_dir=cache_dir)
    elif os.path.isfile(name):
        model_path, cfg = name, {}
    else:
        raise RuntimeError(f"Model {name} not found; available models = {list_openai_models()}")

    sd = {k[7:] if k.startswith("module.") else k: v
          for k, v in read_state_dict(model_path).items()}
    if "text_projection" in sd:  # RN50 / RN101 embed at 1024
        embed_dim = int(sd["text_projection"].shape[1])
    kw = dict(clip_type="CLIP", embed_dim=embed_dim, vocab_path=vocab_path, tiny=tiny,
              checkpoint_path=sd, device=device)
    if any(k.startswith("visual.layer1.") for k in sd):
        rn_width, rn_layers = _rn_geometry(sd)
        model = BiomedCLIP(vision_tower="resnet", rn_layers=rn_layers, rn_width=rn_width, **kw)
    else:
        model = BiomedCLIP(**kw)
    if "logit_scale" in sd:
        model.logit_scale = float(torch.as_tensor(sd["logit_scale"]).float())
    preprocess = image_transform(
        cfg.get("size", 224), is_train=False, mean=cfg.get("mean"), std=cfg.get("std"),
        resize_mode=cfg.get("resize_mode"), interpolation=cfg.get("interpolation"))
    return model, preprocess
