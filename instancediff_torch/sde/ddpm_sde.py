"""Conditional DDPM reverse sampler (port of the sampling half of
``instancediff_tpu/sde/ddpm_sde.py``).

A variance-preserving DDPM on the clean image, x_t = sqrt(abar_t) x0 +
s sqrt(1 - abar_t) eps with s = ``max_sigma``; the degraded input conditions
the net, not the noising. The JAX sampler is one ``lax.scan``; here it is a
Python loop over the strided grid, and every random draw is injectable, as
in ``DriftSDE.reverse_ddpm``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .schedules import strided_sampling_grid

# predict_fn(x_t, t) -> eps_hat; t is a Python int
NoisePredictFn = Callable[[torch.Tensor, int], torch.Tensor]


def make_cosine_alphas_bar(T: int, s: float = 0.008) -> torch.Tensor:
    """The improved-DDPM cosine alpha-bar, [T+1] float32 with abar[0] = 1,
    in float64 numpy first as in the JAX package."""
    t = np.arange(T + 1, dtype=np.float64)
    f = np.cos((t / T + s) / (1 + s) * np.pi / 2.0) ** 2
    abar = np.clip(f / f[0], 1e-8, 1.0)
    return torch.from_numpy(abar.astype(np.float32))


class DDPMSDE:
    """The ``cosine_alpha`` schedule table plus the strided DDIM(eta)
    reverse step. The table stays on the CPU in float32; each step's
    coefficients are float32 scalars, as in the JAX step."""

    def __init__(self, T: int = 100, max_sigma: float = 1.0, schedule: str = "cosine_alpha"):
        if schedule != "cosine_alpha":
            raise ValueError(f"unsupported ddpm schedule '{schedule}'")
        self.T = int(T)
        self.max_sigma = float(max_sigma)
        self.alphas_bar = make_cosine_alphas_bar(self.T)

    def step_coeffs(self, t: int, t_prev: int, eta: float):
        """``(sqrt(abar_t), s*sqrt(1-abar_t), sqrt(abar_p), s*carry, s*sigma)``
        for the step t -> t_prev, as Python floats from float32 arithmetic:
        sigma^2 = eta^2 (1-abar_p)/(1-abar_t) (1-abar_t/abar_p), clipped to
        [0, 1-abar_p] and 0 at t_prev = 0; carry = sqrt(1-abar_p-sigma^2)."""
        abar_t, abar_p = self.alphas_bar[t], self.alphas_bar[t_prev]
        s = torch.tensor(self.max_sigma, dtype=torch.float32)
        sigma2 = (eta**2 * (1.0 - abar_p) / (1.0 - abar_t) * (1.0 - abar_t / abar_p))
        sigma2 = torch.clamp(sigma2, torch.zeros(()), 1.0 - abar_p)
        noise = torch.sqrt(sigma2) if t_prev > 0 else torch.zeros(())
        carry = torch.sqrt(torch.clamp(1.0 - abar_p - sigma2, min=0.0))
        return tuple(float(v) for v in (torch.sqrt(abar_t), s * torch.sqrt(1.0 - abar_t),
                                        torch.sqrt(abar_p), s * carry, s * noise))

    def reverse_step(self, x: torch.Tensor, t: int, t_prev: int, eps_hat: torch.Tensor,
                     z: torch.Tensor, eta: float, clip_x0: bool = True) -> torch.Tensor:
        """One DDIM(eta) step t -> t_prev (eta=1 on the consecutive grid is the
        ancestral DDPM step). ``clip_x0`` clamps the x0 estimate to [-1, 1]
        and re-derives eps from it."""
        sa_t, s_sig_t, sa_p, s_carry, s_noise = self.step_coeffs(t, t_prev, eta)
        eps_hat = eps_hat.to(x.dtype)
        x0_hat = (x - s_sig_t * eps_hat) / sa_t
        if clip_x0:
            x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
            eps_hat = (x - sa_t * x0_hat) / s_sig_t
        return sa_p * x0_hat + s_carry * eps_hat + s_noise * z

    def reverse_ddpm(self, mu: torch.Tensor, predict_fn: NoisePredictFn,
                     sample_steps: Optional[int] = None, eta: Optional[float] = None,
                     clip_x0: bool = True, generator: Optional[torch.Generator] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Sample from pure noise x_T = s * eps, conditioned through the net,
        over the strided grid (``eta`` default 1). ``init_noise`` ([B,H,W,1])
        and ``step_noise`` (one tensor per step) replace draws from
        ``generator``; the draw order is init first, then one per step."""
        eta_v = 1.0 if eta is None else float(eta)
        t_hi, t_lo = strided_sampling_grid(self.T, sample_steps)
        if step_noise is not None and len(step_noise) != len(t_hi):
            raise ValueError(f"step_noise has {len(step_noise)} entries for "
                             f"{len(t_hi)} sampler steps")

        def draw():
            return torch.randn(mu.shape, generator=generator, device=mu.device,
                               dtype=mu.dtype)

        x = (draw() if init_noise is None else init_noise) * self.max_sigma
        for i, (t, tp) in enumerate(zip(t_hi, t_lo)):
            eps_hat = predict_fn(x, t)
            z = draw() if step_noise is None else step_noise[i]
            x = self.reverse_step(x, t, tp, eps_hat, z, eta_v, clip_x0)
        return x
