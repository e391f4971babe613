"""Colour-space conversion (port of ``bgr2ycbcr`` and ``rgb2ycbcr`` in
``instancediff_tpu/data/util.py``): ITU-R BT.601 YCbCr in MATLAB's
convention, on numpy arrays."""

from __future__ import annotations

import numpy as np

_Y = [24.966, 128.553, 65.481]
_YCBCR = [[24.966, 112.0, -18.214],
          [128.553, -74.203, -93.786],
          [65.481, -37.797, 112.0]]


def bgr2ycbcr(img, only_y: bool = True) -> np.ndarray:
    """A BGR image (HWC; uint8 in [0, 255] or float in [0, 1]) in YCbCr, in
    the input's dtype and range: uint8 rounded, float divided by 255. With
    ``only_y`` the luma channel alone (HW)."""
    img = np.asarray(img)
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img *= 255.0
    if only_y:
        rlt = np.dot(img, _Y) / 255.0 + 16.0
    else:
        rlt = np.matmul(img, _YCBCR) / 255.0 + [16, 128, 128]
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt /= 255.0
    return rlt.astype(in_img_type)


def rgb2ycbcr(img, only_y: bool = True) -> np.ndarray:
    """``bgr2ycbcr`` of an RGB image."""
    return bgr2ycbcr(np.asarray(img)[..., ::-1], only_y=only_y)
