"""Degradation synthesis on the device (port of the Gaussian-noise,
speckle, low-dose CT and per-type selection functions of
``instancediff_tpu/ops/degradations.py``).

Every function takes NHWC arrays in [-1, 1] and its random draw (standard
normal; for the L-look speckle Gamma(L, 1)) as a tensor (``noise``) or draws
it from an explicit ``torch.Generator``: torch cannot reproduce JAX's
threefry bits. Also the super-resolution ``upscale`` and the inpainting
``mask_to``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

ARTIFACT_TYPES = (
    "speckle in OCT",
    "speckle in ultra sound",
    "noise in cryo-EM image",
    "noise in low dose CT",
    "Gaussian noise in MRI",
)


def _normal(x, generator, noise):
    if noise is None:
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return noise.to(x.device, x.dtype)


def add_gaussian_noise(x, sigma, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None):
    """Additive Gaussian noise; a sigma above 1 is on the 0..255 scale."""
    sigma = sigma / 255.0 if sigma > 1 else sigma
    return x + _normal(x, generator, noise) * sigma


def add_speckle(x, sigma=0.3, looks=None, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """Multiplicative speckle on [0, 1] intensity: y = s (1 + sigma n),
    n ~ N(0, 1), or with ``looks`` L the L-look speckle y = s g / L, g ~
    Gamma(L, 1) (``noise`` then holds g); clipped to [0, 1]; input and
    output in [-1, 1]."""
    s01 = (x + 1.0) / 2.0
    if looks is None:
        mult = 1.0 + sigma * _normal(x, generator, noise)
    else:
        if noise is None:
            noise = torch._standard_gamma(
                torch.full(x.shape, float(looks), device=x.device, dtype=x.dtype),
                generator=generator)
        mult = noise.to(x.device, x.dtype) / looks
    return torch.clamp(s01 * mult, 0.0, 1.0) * 2.0 - 1.0


def low_dose_sim(x, dose_frac=0.25, i0=1e4, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
    """Low-dose CT: Poisson photon counts at ``dose_frac`` of ``i0`` in their
    Gaussian approximation, back to line integrals, clipped to [0, 1]."""
    s01 = (x + 1.0) / 2.0
    n0 = i0 * dose_frac
    counts = n0 * torch.exp(-s01)
    noisy = torch.clamp(counts + torch.sqrt(counts) * _normal(x, generator, noise), min=1.0)
    return torch.clamp(-torch.log(noisy / n0), 0.0, 1.0) * 2.0 - 1.0


def apply_degradation(x, type_idx, sigma=25.0, generator: Optional[torch.Generator] = None,
                      noise: Optional[Sequence[torch.Tensor]] = None):
    """The degradation of each sample's ``type_idx`` (the five artifact
    types in order): all five candidates are computed and each sample takes
    its own, as JAX's ``take_along_axis`` does. ``noise``: the five
    candidates' standard-normal draws (each like x), else drawn from
    ``generator`` in candidate order."""
    noise = [None] * 5 if noise is None else list(noise)
    if len(noise) != 5:
        raise ValueError(f"apply_degradation takes 5 noise tensors, got {len(noise)}")
    kw = [dict(generator=generator, noise=n) for n in noise]
    cands = torch.stack([
        add_speckle(x, sigma=0.35, **kw[0]),          # 0 speckle in OCT
        add_speckle(x, sigma=0.25, **kw[1]),          # 1 speckle in ultrasound
        add_gaussian_noise(x, 2.0 * sigma, **kw[2]),  # 2 cryo-EM noise (heavy)
        low_dose_sim(x, **kw[3]),                     # 3 low dose CT
        add_gaussian_noise(x, sigma, **kw[4]),        # 4 Gaussian noise in MRI
    ])  # [5, B, H, W, C]
    idx = torch.as_tensor(type_idx, device=x.device).long().reshape((1, -1) + (1,) * (x.ndim - 1))
    return torch.take_along_dim(cands, idx.expand((1,) + tuple(x.shape)), dim=0)[0]


def upscale(x: torch.Tensor, scale: int = 4, method: str = "bicubic") -> torch.Tensor:
    """An NHWC batch upscaled by the integer ``scale``: ``bicubic`` is
    torch's (a = -0.75, ``align_corners=False``, border taps clamped), which
    the JAX package writes out by hand; ``bilinear`` and ``nearest`` sample
    at half-pixel centres as ``jax.image.resize`` does when it upsamples."""
    mode = {"bicubic": "bicubic", "bilinear": "bilinear", "nearest": "nearest-exact"}.get(method)
    if mode is None:
        raise ValueError(f"unknown upscale method '{method}'")
    kw = {} if mode == "nearest-exact" else {"align_corners": False}
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=int(scale), mode=mode, **kw)
    return y.permute(0, 2, 3, 1)


def mask_to(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inpainting: keep ``x`` where ``mask`` is 1, fill the rest with 1.0."""
    return mask * x + (1.0 - mask)
