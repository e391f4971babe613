"""Image and raw-array output helpers (port of ``tensor2img``, ``save_img``
and ``save_raw`` in ``instancediff_tpu/utils/img_utils.py``)."""

from __future__ import annotations

import os

import numpy as np


def tensor2img(tensor, out_type=np.uint8, min_max=(0, 1)):
    """A [C,H,W] or [H,W] float array in ``min_max`` as an image array (HWC,
    uint8 by default)."""
    img = np.asarray(tensor, dtype=np.float32)
    img = np.clip((img - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3:
        if img.shape[0] in (1, 3):  # CHW -> HWC
            img = np.transpose(img, (1, 2, 0))
        if img.shape[-1] == 1:
            img = img[..., 0]
    if out_type == np.uint8:
        img = (img * 255.0).round().astype(np.uint8)
    else:
        img = img.astype(out_type)
    return img


def save_img(img, img_path):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    Image.fromarray(img).save(img_path)


def save_raw(arr, path):
    """Write an array as flat float32 (the reference's ``.raw`` format)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.asarray(arr, dtype=np.float32).tofile(path)
