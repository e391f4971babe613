"""Degradation synthesis on the device (port of the Gaussian-noise,
speckle, low-dose CT and per-type selection functions of
``instancediff_tpu/ops/degradations.py``).

Every function takes NHWC arrays in [-1, 1] and its standard-normal draw as
a tensor (``noise``) or draws it from an explicit ``torch.Generator``: torch
cannot reproduce JAX's threefry bits. The gamma speckle (``looks=``), the
bicubic ``upscale`` and ``mask_to`` are not ported."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
    n ~ N(0, 1), clipped to [0, 1]; input and output in [-1, 1]."""
    if looks is not None:
        raise NotImplementedError("the gamma speckle (looks=) is not ported "
                                  "(ROADMAP queue 1)")
    s01 = (x + 1.0) / 2.0
    mult = 1.0 + sigma * _normal(x, generator, noise)
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
