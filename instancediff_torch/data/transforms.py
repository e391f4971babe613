"""CLIP-style image preprocessing for the conditioning towers (port of
``instancediff_tpu/data/transforms.py``, a copy: it is numpy and PIL on the
host, and the port imports nothing of the JAX package). ``PreprocessCfg`` /
``AugmentationCfg`` / ``image_transform``: eval = resize (shortest, longest
or squash) + centre crop (or pad) + RGB + normalise; train =
RandomResizedCrop + optional colour jitter / grayscale + normalise. Outputs
are NHWC float32 [H, W, 3], as the towers take them; train-time randomness
comes from an explicit ``numpy.random.Generator``, so the same generator
gives the same bytes as the JAX package's transforms.
"""

from __future__ import annotations

import numbers
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_2tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


@dataclass
class PreprocessCfg:
    """Tower preprocessing contract (reference transform.py:17-37)."""

    size: Union[int, Tuple[int, int]] = 224
    mode: str = "RGB"
    mean: Tuple[float, ...] = OPENAI_DATASET_MEAN
    std: Tuple[float, ...] = OPENAI_DATASET_STD
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    fill_color: int = 0

    def __post_init__(self):
        assert self.mode in ("RGB",)

    @property
    def num_channels(self):
        return 3

    @property
    def input_size(self):
        # (H, W, C); the reference reports CHW
        return _to_2tuple(self.size) + (self.num_channels,)


_PREPROCESS_KEYS = set(asdict(PreprocessCfg()).keys())


def merge_preprocess_dict(base, overlay: Dict):
    """Overlay preprocess keys on a cfg/dict, dropping unknown keys
    (reference transform.py:40-55)."""
    base_clean = (asdict(base) if isinstance(base, PreprocessCfg)
                  else {k: v for k, v in base.items() if k in _PREPROCESS_KEYS})
    if overlay:
        base_clean.update({k: v for k, v in overlay.items()
                           if k in _PREPROCESS_KEYS and v is not None})
    return base_clean


def merge_preprocess_kwargs(base: PreprocessCfg, **kwargs):
    return merge_preprocess_dict(base, kwargs)


@dataclass
class AugmentationCfg:
    """Train-time augmentation knobs (reference transform.py:62-72)."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Optional[Tuple[float, float]] = None
    color_jitter: Optional[Union[float, Tuple[float, ...]]] = None
    re_prob: Optional[float] = None
    re_count: Optional[int] = None
    use_timm: bool = False
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None


def _as_pil(img):
    from PIL import Image

    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr,
                      0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def _resample(interpolation):
    from PIL import Image

    return (Image.Resampling.BILINEAR if interpolation == "bilinear"
            else Image.Resampling.BICUBIC)


def _resize(img, hw, interpolation):
    return img.resize((hw[1], hw[0]), resample=_resample(interpolation))


def _resize_shortest(img, size, interpolation):
    w, h = img.size
    short, target = min(w, h), size
    scale = target / short
    return _resize(img, (round(h * scale), round(w * scale)), interpolation)


def _resize_longest(img, size_hw, interpolation):
    w, h = img.size
    scale = min(size_hw[0] / h, size_hw[1] / w)
    return _resize(img, (round(h * scale), round(w * scale)), interpolation)


def _center_crop_or_pad(arr, size_hw, fill=0):
    """Crop center when larger, pad symmetrically when smaller
    (reference transform.py:167-235)."""
    th, tw = size_hw
    h, w = arr.shape[:2]
    if h < th or w < tw:
        pt = max((th - h) // 2, 0)
        pl = max((tw - w) // 2, 0)
        arr = np.pad(arr,
                     ((pt, max(th - h - pt, 0)), (pl, max(tw - w - pl, 0)),
                      (0, 0)),
                     constant_values=fill)
        h, w = arr.shape[:2]
    i = (h - th) // 2
    j = (w - tw) // 2
    return arr[i:i + th, j:j + tw]


def _normalize(arr, mean, std):
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _random_resized_crop(img, size_hw, scale, ratio, interpolation, rng):
    """torchvision RandomResizedCrop.get_params semantics: 10 attempts at a
    log-uniform aspect ratio / uniform area crop, center fallback."""
    w, h = img.size
    area = h * w
    ratio = ratio or (3 / 4, 4 / 3)
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            box = (j, i, j + cw, i + ch)
            return img.resize((size_hw[1], size_hw[0]),
                              resample=_resample(interpolation), box=box)
    # fallback: center crop at the in-range aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    i, j = (h - ch) // 2, (w - cw) // 2
    return img.resize((size_hw[1], size_hw[0]),
                      resample=_resample(interpolation),
                      box=(j, i, j + cw, i + ch))


def _color_jitter(arr, brightness, contrast, saturation, hue, rng):
    """Order-randomised brightness/contrast/saturation jitter on [0,1] RGB
    (hue accepted for API parity; applied as a channel roll-free luma-safe
    no-op when 0)."""
    def _b(a, f):
        return np.clip(a * f, 0, 1)

    def _c(a, f):
        m = a.mean()
        return np.clip((a - m) * f + m, 0, 1)

    def _s(a, f):
        gray = a @ np.array([0.299, 0.587, 0.114], np.float32)
        return np.clip((a - gray[..., None]) * f + gray[..., None], 0, 1)

    fb = rng.uniform(max(0, 1 - brightness), 1 + brightness)
    fc = rng.uniform(max(0, 1 - contrast), 1 + contrast)
    fs = rng.uniform(max(0, 1 - saturation), 1 + saturation)
    ops = [lambda a: _b(a, fb), lambda a: _c(a, fc), lambda a: _s(a, fs)]
    for k in rng.permutation(3):
        arr = ops[int(k)](arr)
    if hue:
        # cheap hue rotation in YIQ (exact torchvision parity not needed for
        # a prob-gated aug; bounded by the same |hue| <= 0.5 contract)
        fh = rng.uniform(-hue, hue) * 2 * np.pi
        yiq = arr @ np.array([[0.299, 0.595716, 0.211456],
                              [0.587, -0.274453, -0.522591],
                              [0.114, -0.321263, 0.311135]], np.float32)
        c, s = np.cos(fh), np.sin(fh)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        arr = np.clip((yiq @ rot) @ np.array(
            [[1.0, 1.0, 1.0],
             [0.9563, -0.2721, -1.107],
             [0.621, -0.6474, 1.7046]], np.float32).T, 0, 1)
    return arr


def image_transform(
    image_size,
    is_train: bool,
    mean=None,
    std=None,
    resize_mode: Optional[str] = None,
    interpolation: Optional[str] = None,
    fill_color: int = 0,
    aug_cfg: Optional[Union[Dict[str, Any], AugmentationCfg]] = None,
):
    """Build the preprocessing callable (reference transform.py:274-390).

    Returns ``fn(img) -> float32 [H, W, 3]`` (NHWC, normalized);
    train-mode callables take an optional ``rng=np.random.Generator``.
    """
    mean = tuple(mean) if isinstance(mean, (list, tuple)) else (
        OPENAI_DATASET_MEAN if mean is None else (mean,) * 3)
    std = tuple(std) if isinstance(std, (list, tuple)) else (
        OPENAI_DATASET_STD if std is None else (std,) * 3)
    interpolation = interpolation or "bicubic"
    assert interpolation in ("bicubic", "bilinear", "random")
    if interpolation == "random":  # eval never uses random interpolation
        interpolation = "bicubic"
    resize_mode = resize_mode or "shortest"
    assert resize_mode in ("shortest", "longest", "squash")
    size_hw = _to_2tuple(image_size)
    if isinstance(aug_cfg, dict):
        aug_cfg = AugmentationCfg(**aug_cfg)
    aug_cfg = aug_cfg or AugmentationCfg()

    if is_train:
        if aug_cfg.use_timm:
            raise NotImplementedError(
                "timm's aug factory is not ported; the pipeline covers the fork's "
                "non-timm train path")

        def train_fn(img, rng: Optional[np.random.Generator] = None):
            rng = rng or np.random.default_rng()
            pil = _as_pil(img).convert("RGB")
            pil = _random_resized_crop(pil, size_hw, aug_cfg.scale,
                                       aug_cfg.ratio, "bicubic", rng)
            arr = np.asarray(pil, np.float32) / 255.0
            if aug_cfg.color_jitter_prob and aug_cfg.color_jitter is not None:
                cj = aug_cfg.color_jitter
                cj = (cj,) * 3 + (0.0,) if isinstance(cj, numbers.Number) else tuple(cj)
                assert len(cj) == 4
                if rng.uniform() < aug_cfg.color_jitter_prob:
                    arr = _color_jitter(arr, *cj, rng)
            if aug_cfg.gray_scale_prob and rng.uniform() < aug_cfg.gray_scale_prob:
                gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
                arr = np.repeat(gray[..., None], 3, axis=-1)
            return ((arr - np.asarray(mean, np.float32))
                    / np.asarray(std, np.float32))

        return train_fn

    def eval_fn(img):
        pil = _as_pil(img).convert("RGB")
        if resize_mode == "squash":
            pil = _resize(pil, size_hw, interpolation)
            arr = np.asarray(pil, np.uint8)
        elif resize_mode == "longest":
            pil = _resize_longest(pil, size_hw, interpolation)
            arr = _center_crop_or_pad(np.asarray(pil, np.uint8), size_hw,
                                      fill=fill_color)
        else:  # shortest
            pil = (_resize_shortest(pil, size_hw[0], interpolation)
                   if size_hw[0] == size_hw[1] else
                   _resize_longest(pil, size_hw, interpolation))
            arr = _center_crop_or_pad(np.asarray(pil, np.uint8), size_hw)
        return _normalize(arr, mean, std)

    return eval_fn


def image_transform_v2(cfg: PreprocessCfg, is_train: bool, aug_cfg=None):
    """Cfg-object entry point (reference transform.py:393-407)."""
    return image_transform(
        image_size=cfg.size, is_train=is_train, mean=cfg.mean, std=cfg.std,
        interpolation=cfg.interpolation, resize_mode=cfg.resize_mode,
        fill_color=cfg.fill_color, aug_cfg=aug_cfg)
