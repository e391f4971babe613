"""Pretrained-asset registry for the conditioning towers (port of
``instancediff_tpu/models/pretrained.py``, a copy of its table and query
API): ``list_pretrained``, ``get_pretrained_cfg``, ... and local checkpoint
resolution.

- ``download_pretrained`` resolves assets from LOCAL caches only and never
  opens a network connection; it says where to place each artifact instead
  of fetching it.
- each cfg's ``converter`` names the torch-checkpoint converter in this
  package (``module.function`` under ``instancediff_torch.models``), so
  resolving a tag yields everything needed to fill a module (the CoCa rows:
  ``coca.load_torch_coca_weights``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _pcfg(url="", hf_hub="", **kwargs):
    """OpenAI / OpenCLIP preprocessing defaults (reference :23-33)."""
    return {"url": url, "hf_hub": hf_hub, "mean": OPENAI_DATASET_MEAN,
            "std": OPENAI_DATASET_STD, "interpolation": "bicubic",
            "resize_mode": "shortest", **kwargs}


def _slpcfg(url="", hf_hub="", **kwargs):
    """SigLIP defaults (reference :36-46)."""
    return {"url": url, "hf_hub": hf_hub, "mean": INCEPTION_MEAN,
            "std": INCEPTION_STD, "interpolation": "bicubic",
            "resize_mode": "squash", **kwargs}


def _apcfg(url="", hf_hub="", **kwargs):
    """CLIPA defaults (reference :49-59)."""
    return {"url": url, "hf_hub": hf_hub, "mean": IMAGENET_MEAN,
            "std": IMAGENET_STD, "interpolation": "bilinear",
            "resize_mode": "squash", **kwargs}


# model architecture -> {pretrain tag -> cfg}. Only rows with a consumer in
# this package carry a converter; the rest are preprocessing metadata.
_PRETRAINED: Dict[str, Dict[str, dict]] = {
    "ViT-B-32": {
        "openai": _pcfg(
            url="https://openaipublic.azureedge.net/clip/models/"
                "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/"
                "ViT-B-32.pt",
            filename="ViT-B-32.pt",
            converter="text_encoder.load_torch_clip_text_weights"),
    },
    "ViT-B-16": {
        "openai": _pcfg(
            url="https://openaipublic.azureedge.net/clip/models/"
                "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/"
                "ViT-B-16.pt",
            filename="ViT-B-16.pt",
            converter="clip_vit.load_torch_clip_vision_weights"),
    },
    "hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224": {
        "biomedclip": _pcfg(
            hf_hub="microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224",
            filename="open_clip_pytorch_model.bin",
            converter="text_encoder.load_torch_bert_weights"),
    },
    "ViT-B-16-SigLIP": {
        # converter reads the official big_vision .npz release (the loader
        # is npz-only; the hf_hub mirror's torch .bin has no consumer here)
        "webli": _slpcfg(hf_hub="timm/ViT-B-16-SigLIP",
                         filename="webli_en_b16_224_63724782.npz",
                         converter="big_vision.load_big_vision_weights"),
    },
    "ViT-L-16-CL32-GAP": {
        "clipa": _apcfg(filename="vit_l16_cl32_gap.pt"),
    },
    # CoCa registry rows (reference pretrained.py:279-286,324-325)
    "coca_ViT-B-32": {
        "laion2b_s13b_b90k": _pcfg(
            hf_hub="laion/CoCa-ViT-B-32-laion2B-s13B-b90k/",
            filename="open_clip_pytorch_model.bin",
            converter="coca.load_torch_coca_weights"),
        "mscoco_finetuned_laion2b_s13b_b90k": _pcfg(
            hf_hub="laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/",
            filename="open_clip_pytorch_model.bin",
            converter="coca.load_torch_coca_weights"),
    },
    "coca_ViT-L-14": {
        "laion2b_s13b_b90k": _pcfg(
            hf_hub="laion/CoCa-ViT-L-14-laion2B-s13B-b90k/",
            filename="open_clip_pytorch_model.bin",
            converter="coca.load_torch_coca_weights"),
        "mscoco_finetuned_laion2b_s13b_b90k": _pcfg(
            hf_hub="laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k/",
            filename="open_clip_pytorch_model.bin",
            converter="coca.load_torch_coca_weights"),
    },
}


def _clean_tag(tag: str) -> str:
    return tag.lower().replace("-", "_")


def list_pretrained(as_str: bool = False):
    """All (model, tag) pairs, or 'model:tag' strings (reference :418-423)."""
    return [":".join([k, t]) if as_str else (k, t)
            for k in _PRETRAINED for t in _PRETRAINED[k]]


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    tag = _clean_tag(tag)
    return [k for k in _PRETRAINED if tag in _PRETRAINED[k]]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_PRETRAINED.get(model, {}).keys())


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _clean_tag(tag) in _PRETRAINED.get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> dict:
    return dict(_PRETRAINED.get(model, {}).get(_clean_tag(tag), {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def _default_cache_dirs() -> List[str]:
    dirs = []
    if os.environ.get("INSTANCEDIFF_ASSETS"):
        dirs.append(os.environ["INSTANCEDIFF_ASSETS"])
    dirs += [os.path.expanduser("~/.cache/instancediff"),
             os.path.join(os.path.dirname(os.path.dirname(
                 os.path.dirname(os.path.abspath(__file__)))), "pretrained")]
    return dirs


def download_pretrained(cfg: dict, cache_dir: Optional[str] = None) -> str:
    """Resolve a registry cfg to a LOCAL checkpoint path.

    Unlike the reference (:526-553, urllib/hf_hub download), this never
    touches the network: it searches ``cache_dir``, ``$INSTANCEDIFF_ASSETS``,
    ``~/.cache/instancediff`` and ``<repo>/pretrained`` for ``cfg['filename']``
    and raises with provisioning instructions when absent."""
    filename = cfg.get("filename") or os.path.basename(cfg.get("url", ""))
    if not filename:
        raise ValueError(f"pretrained cfg has no filename/url: {cfg}")
    search = ([cache_dir] if cache_dir else []) + _default_cache_dirs()
    for d in search:
        p = os.path.join(d, filename)
        if os.path.isfile(p):
            return p
    src = cfg.get("url") or f"hf-hub:{cfg.get('hf_hub')}"
    raise FileNotFoundError(
        f"pretrained asset {filename!r} not found in {search}; this host has "
        f"no egress — provision it out-of-band from {src} into one of those "
        f"directories (or set $INSTANCEDIFF_ASSETS)")


def resolve_converter(cfg: dict):
    """The callable a cfg's ``converter`` names (``module.function`` under
    ``instancediff_torch.models``), or None for a row without one."""
    import importlib

    conv = cfg.get("converter")
    if conv is None:
        return None
    mod_name, _, fn_name = conv.rpartition(".")
    return getattr(importlib.import_module(f"instancediff_torch.models.{mod_name}"), fn_name)


def resolve_pretrained(model: str, tag: str,
                       cache_dir: Optional[str] = None) -> Tuple[str, dict]:
    """(local checkpoint path, cfg incl. the converter name) for a tag; its
    converter is resolved first, so a row naming none the port has raises."""
    cfg = get_pretrained_cfg(model, tag)
    if not cfg:
        raise KeyError(f"no pretrained cfg for {model}:{tag}; known: "
                       f"{list_pretrained(as_str=True)}")
    resolve_converter(cfg)
    return download_pretrained(cfg, cache_dir), cfg
