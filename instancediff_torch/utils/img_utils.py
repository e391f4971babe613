"""Image and raw-array helpers (port of ``tensor2img``, ``img2tensor``,
``save_img``, ``save_raw``, ``load_raw`` and the MATLAB-convention
``calculate_psnr`` / ``calculate_ssim`` in
``instancediff_tpu/utils/img_utils.py``).

The MATLAB-convention metrics here take [0, 255] images and crop the SSIM
window's valid region; they are not ``utils/metrics.py``'s, which follow
skimage on [0, 1] images (the reference's testUM metrics)."""

from __future__ import annotations

import os

import numpy as np
import torch


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


def img2tensor(img) -> torch.Tensor:
    """An HWC (or HW) uint8 or float image as a [C,H,W] float32 tensor in
    [0, 1]: uint8 images, and float images whose largest value exceeds 1.5,
    are divided by 255."""
    src = np.asarray(img)
    arr = src.astype(np.float32)
    if src.dtype == np.uint8 or arr.max() > 1.5:
        arr = arr / 255.0
    arr = arr[None] if arr.ndim == 2 else np.transpose(arr, (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))


def save_img(img, img_path):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    Image.fromarray(img).save(img_path)


def save_raw(arr, path):
    """Write an array as flat float32 (the reference's ``.raw`` format)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.asarray(arr, dtype=np.float32).tofile(path)


def load_raw(path, shape=(1, 224, 224)) -> np.ndarray:
    """A raw float32 file read into ``shape`` (the datasets' ``.raw``)."""
    return np.fromfile(path, dtype=np.float32).reshape(shape)


def _gaussian_kernel_1d(size=11, sigma=1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _filter_valid(img, g) -> np.ndarray:
    """Separable Gaussian correlation over the valid region only: the
    reference's ``cv2.filter2D`` followed by its [5:-5, 5:-5] crop (the
    border handling never reaches the valid region)."""
    out = np.apply_along_axis(lambda r: np.convolve(r, g, mode="valid"), 1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, g, mode="valid"), 0, out)


def calculate_psnr(img1, img2) -> float:
    """MATLAB-convention PSNR of [0, 255] images (inf when they are equal)."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _ssim_2d(img1, img2) -> float:
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    g = _gaussian_kernel_1d()
    mu1 = _filter_valid(img1, g)
    mu2 = _filter_valid(img2, g)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(img1 ** 2, g) - mu1_sq
    sigma2_sq = _filter_valid(img2 ** 2, g) - mu2_sq
    sigma12 = _filter_valid(img1 * img2, g) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1, img2) -> float:
    """MATLAB-convention SSIM of [0, 255] images: an 11x11 sigma-1.5
    Gaussian window, the mean over the valid region; HW, or HWC with 1 or 3
    channels (the channels' mean)."""
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_2d(img1, img2)
    if img1.ndim == 3 and img1.shape[2] in (1, 3):
        return float(np.mean([_ssim_2d(img1[..., i], img2[..., i])
                              for i in range(img1.shape[2])]))
    raise ValueError("Wrong input image dimensions.")
