"""Restoration metrics at skimage parity (port of ``calculate_rmse``,
``calculate_psnr``, ``calculate_ssim`` and ``eval_restoration`` in
``instancediff_tpu/utils/metrics.py``), with numpy and scipy.

The reference's settings: PSNR with ``data_range=1``; SSIM as
``skimage.metrics.structural_similarity`` with ``gaussian_weights=True,
sigma=1.5, win_size=11, use_sample_covariance=False, K1=0.01, K2=0.03,
data_range=1`` (Gaussian-weighted local statistics, truncate 3.5, population
covariance, a ``(win_size-1)//2`` border crop before the mean); RMSE over the
whole array; all on outputs rescaled by ``x/2 + 0.5``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter


def calculate_rmse(pred, target):
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    return float(np.sqrt(np.mean((pred - target) ** 2)))


def calculate_psnr(pred, target, data_range=1.0):
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    mse = np.mean((pred - target) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / mse))


def calculate_ssim(
    pred,
    target,
    data_range=1.0,
    win_size=11,
    sigma=1.5,
    K1=0.01,
    K2=0.03,
    gaussian_weights=True,
    use_sample_covariance=False,
):
    """SSIM matching ``skimage.metrics.structural_similarity`` for 2D single-
    channel images with the reference's settings (testUM.py:162-164)."""
    im1 = np.asarray(pred, dtype=np.float64).squeeze()
    im2 = np.asarray(target, dtype=np.float64).squeeze()
    if im1.ndim != 2:
        raise ValueError(f"expected 2D image after squeeze, got {im1.shape}")

    truncate = 3.5
    if gaussian_weights:
        # radius = int(truncate * sigma + 0.5) = 5 -> effective 11-tap window
        def filt(x):
            return gaussian_filter(x, sigma=sigma, truncate=truncate)

        NP = win_size ** im1.ndim
    else:
        from scipy.ndimage import uniform_filter

        def filt(x):
            return uniform_filter(x, size=win_size)

        NP = win_size ** im1.ndim

    cov_norm = NP / (NP - 1) if use_sample_covariance else 1.0

    ux = filt(im1)
    uy = filt(im2)
    uxx = filt(im1 * im1)
    uyy = filt(im2 * im2)
    uxy = filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def eval_restoration(pred, target):
    """Compute the (RMSE, SSIM, PSNR) triple on [-1,1] outputs the way
    testUM.py:151-164 does: rescale by ``x/2 + 0.5`` first."""
    pred01 = np.asarray(pred) / 2.0 + 0.5
    target01 = np.asarray(target) / 2.0 + 0.5
    return {
        "RMSE": calculate_rmse(pred01, target01),
        "SSIM": calculate_ssim(pred01, target01),
        "PSNR": calculate_psnr(pred01, target01, data_range=1.0),
    }
