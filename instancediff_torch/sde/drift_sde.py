"""Instance-wise drift SDE reverse sampler (port of
``instancediff_tpu/sde/drift_sde.py``).

The JAX sampler is one ``lax.scan``; here it is a Python loop over the
strided grid. Torch cannot reproduce JAX's threefry bits, so every random
draw is injectable: ``reverse_ddpm`` takes the initial noise and the per-step
noise as tensors, or draws them from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .schedules import make_schedule, strided_sampling_grid

# predict_fn(x_t, t) -> (pred_drift, pred_noise); t is a Python int
PredictFn = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


class DriftSDE:
    """Schedule tables plus the ancestral reverse step. Tables stay on the
    CPU in float32; a step reads its scalars from them as Python floats."""

    def __init__(self, T: int = 100, max_sigma: float = 0.4,
                 drift_schedule: str = "sigmoid", noise_schedule: str = "sigmoid",
                 eta: float = 1.0):
        self.T = int(T)
        self.max_sigma = float(max_sigma)
        self.eta = float(eta)
        self.drift_schedule = make_schedule(drift_schedule, self.T)
        self.noise_schedule = make_schedule(noise_schedule, self.T)
        self.sigmas = self.max_sigma * torch.sqrt(self.noise_schedule)

    def init_state(self, mu: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """x_T = mu + sigma_T * eps (the exact t=T marginal)."""
        return mu + float(self.sigmas[self.T]) * eps

    @staticmethod
    def posterior_coeffs(sig_t: torch.Tensor, sig_p: torch.Tensor, eta: float):
        """``(carry, c)`` with carry^2 + c^2 = sig_p^2: the coefficient on the
        carried noise prediction and the fresh-noise std (float32 scalars)."""
        ratio = torch.where(sig_t > 0, sig_p / torch.clamp(sig_t, min=1e-12),
                            torch.zeros_like(sig_t))
        c = eta * sig_p * torch.sqrt(torch.clamp(1.0 - ratio**2, 0.0, 1.0))
        carry = torch.sqrt(torch.clamp(sig_p**2 - c**2, min=0.0))
        return carry, c

    def reverse_step(self, x_t: torch.Tensor, t: int, t_prev: int, pred_drift,
                     pred_noise, z: torch.Tensor, eta: float) -> torch.Tensor:
        """One ancestral step t -> t_prev (any t_prev < t). eta=1 is the DDPM
        posterior, eta=0 the deterministic DDIM-style step."""
        sd_t = float(self.drift_schedule[t])
        sd_p = float(self.drift_schedule[t_prev])
        sig_t, sig_p = self.sigmas[t], self.sigmas[t_prev]
        carry, c = self.posterior_coeffs(sig_t, sig_p, eta)
        # nets may compute in bf16; the sampler state keeps its own dtype
        pd = pred_drift.to(x_t.dtype)
        pn = pred_noise.to(x_t.dtype)
        x0_hat = x_t - sd_t * pd - float(sig_t) * pn
        return x0_hat + sd_p * pd + float(carry) * pn + float(c) * z

    def reverse_ddpm(self, mu: torch.Tensor, predict_fn: PredictFn,
                     eta: Optional[float] = None, sample_steps: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None):
        """Reverse sampler over the strided grid. ``init_noise`` ([B,H,W,1])
        and ``step_noise`` (one tensor per step) replace draws from
        ``generator``; the draw order is init first, then one per step."""
        eta_v = self.eta if eta is None else eta
        t_hi, t_lo = strided_sampling_grid(self.T, sample_steps)
        if step_noise is not None and len(step_noise) != len(t_hi):
            raise ValueError(f"step_noise has {len(step_noise)} entries for "
                             f"{len(t_hi)} sampler steps")

        def draw():
            return torch.randn(mu.shape, generator=generator, device=mu.device,
                               dtype=mu.dtype)

        x = self.init_state(mu, draw() if init_noise is None else init_noise)
        for i, (t, tp) in enumerate(zip(t_hi, t_lo)):
            pred_drift, pred_noise = predict_fn(x, t)
            z = draw() if step_noise is None else step_noise[i]
            x = self.reverse_step(x, t, tp, pred_drift, pred_noise, z, eta_v)
        return x
