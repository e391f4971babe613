"""Instance-wise drift SDE: the forward diffusion the train step draws and
the reverse sampler (port of ``instancediff_tpu/sde/drift_sde.py``).

The JAX sampler is one ``lax.scan`` whose body takes the timestep as data.
Here the body is ``DriftSDE.step``: it reads its coefficients from a
per-call table on the device (``coeff_table``), so a Python loop and a
captured CUDA graph run the same step (``stepping.py``). Torch cannot
reproduce JAX's threefry bits, so every random draw is injectable:
``forward_diffusion`` takes the timesteps and the noise as tensors, and
``reverse_ddpm`` the initial noise and the per-step noise, or they draw them
from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .schedules import make_schedule, strided_sampling_grid
from .stepping import SamplerState, run_steps

# predict_fn(x_t, row) -> (pred_drift, pred_noise); row is the step's
# coefficient row, row[0] its timestep t
PredictFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class DriftSDE:
    """Schedule tables plus the ancestral reverse step. The schedule tables
    stay on the CPU in float32; a sampler call turns the ones its grid needs
    into a coefficient table on its device."""

    # the columns of ``coeff_table``
    COLUMNS = ("t", "t_prev", "sd_t", "sd_p", "sig_t", "carry", "c")

    def __init__(self, T: int = 100, max_sigma: float = 0.4,
                 drift_schedule: str = "sigmoid", noise_schedule: str = "sigmoid",
                 eta: float = 1.0):
        self.T = int(T)
        self.max_sigma = float(max_sigma)
        self.eta = float(eta)
        self.drift_schedule = make_schedule(drift_schedule, self.T)
        self.noise_schedule = make_schedule(noise_schedule, self.T)
        self.sigmas = self.max_sigma * torch.sqrt(self.noise_schedule)

    def marginal(self, x0: torch.Tensor, mu: torch.Tensor, t):
        """Mean and std of x_t | (x0, mu) for integer t [B] (or a scalar):
        ``(x0 + s_d[t] (mu - x0), sigma[t])``, each shaped to broadcast over
        x0's trailing axes."""
        t = torch.as_tensor(t, device=x0.device)
        bshape = (-1,) + (1,) * (x0.ndim - 1)
        sd = self.drift_schedule.to(x0.device)[t].reshape(bshape)
        sig = self.sigmas.to(x0.device)[t].reshape(bshape)
        return x0 + sd * (mu - x0), sig

    def forward_diffusion(self, x0: torch.Tensor, mu: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          t: Optional[torch.Tensor] = None,
                          std_noise: Optional[torch.Tensor] = None):
        """``(t, x_t, drift, std_noise, noise)`` for a batch: t ~ U{1..T} per
        sample, shaped [B,1,1,1]; ``drift`` the scheduled drift
        s_d[t] (mu - x0); ``std_noise`` ~ N(0, I) like x0; ``noise`` =
        sigma[t] std_noise; x_t = x0 + drift + noise. ``t`` ([B] ints) and
        ``std_noise`` replace draws from ``generator`` (t first, then the
        noise)."""
        B = x0.shape[0]
        if t is None:
            t = torch.randint(1, self.T + 1, (B,), generator=generator, device=x0.device)
        t = torch.as_tensor(t, device=x0.device).long().reshape(B)
        if std_noise is None:
            std_noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                    dtype=x0.dtype)
        std_noise = std_noise.to(x0.device, x0.dtype)
        bshape = (B,) + (1,) * (x0.ndim - 1)
        sd = self.drift_schedule.to(x0.device)[t].reshape(bshape).to(x0.dtype)
        sig = self.sigmas.to(x0.device)[t].reshape(bshape).to(x0.dtype)
        drift = sd * (mu - x0)
        noise = sig * std_noise
        return t.reshape(bshape), x0 + drift + noise, drift, std_noise, noise

    @staticmethod
    def posterior_coeffs(sig_t: torch.Tensor, sig_p: torch.Tensor, eta: float):
        """``(carry, c)`` with carry^2 + c^2 = sig_p^2: the coefficient on the
        carried noise prediction and the fresh-noise std (float32, elementwise)."""
        ratio = torch.where(sig_t > 0, sig_p / torch.clamp(sig_t, min=1e-12),
                            torch.zeros_like(sig_t))
        c = eta * sig_p * torch.sqrt(torch.clamp(1.0 - ratio**2, 0.0, 1.0))
        carry = torch.sqrt(torch.clamp(sig_p**2 - c**2, min=0.0))
        return carry, c

    def coeff_table(self, sample_steps: Optional[int] = None, eta: Optional[float] = None,
                    device="cpu") -> torch.Tensor:
        """[n_steps, 7] float32 on ``device``, one row per step of the strided
        grid in sampling order, columns ``COLUMNS``: the step t -> t_prev,
        the drift levels at both ends, sigma_t, and ``posterior_coeffs`` at
        ``eta`` (default the SDE's), all in float32 arithmetic."""
        eta_v = self.eta if eta is None else float(eta)
        t_hi, t_lo = strided_sampling_grid(self.T, sample_steps)
        t, tp = torch.tensor(t_hi), torch.tensor(t_lo)
        sig_t, sig_p = self.sigmas[t], self.sigmas[tp]
        carry, c = self.posterior_coeffs(sig_t, sig_p, eta_v)
        table = torch.stack([t.float(), tp.float(), self.drift_schedule[t],
                             self.drift_schedule[tp], sig_t, carry, c], dim=1)
        return table.to(device)

    def init_state(self, mu: torch.Tensor, eps: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """x_T = mu + sigma_T * eps (the exact t=T marginal); every grid
        starts at T, so sigma_T is the first row's sig_t."""
        return mu + table[0, self.COLUMNS.index("sig_t")] * eps

    def reverse_step(self, x_t: torch.Tensor, row: torch.Tensor, pred_drift,
                     pred_noise, z: torch.Tensor) -> torch.Tensor:
        """One ancestral step t -> t_prev with the coefficients of ``row``.
        eta=1 is the DDPM posterior, eta=0 the deterministic DDIM-style step."""
        _, _, sd_t, sd_p, sig_t, carry, c = row.unbind()
        # nets may compute in bf16; the sampler state keeps its own dtype
        pd = pred_drift.to(x_t.dtype)
        pn = pred_noise.to(x_t.dtype)
        x0_hat = x_t - sd_t * pd - sig_t * pn
        return x0_hat + sd_p * pd + carry * pn + c * z

    def reverse_step_at(self, x_t: torch.Tensor, t, t_prev, pred_drift, pred_noise,
                        eta: float, z: torch.Tensor) -> torch.Tensor:
        """One ancestral step t -> t_prev at per-sample integer timesteps
        ``t``/``t_prev`` ([B]; JAX's ``reverse_step`` with ``t_prev`` and
        ``z`` given): the schedule values gathered at each sample's pair and
        cast to x_t's dtype, the noise split from ``posterior_coeffs``. The
        distillation step's teacher rollout uses it; the sampler reads its
        coefficients from a table row (``reverse_step``)."""
        t = torch.as_tensor(t, device=x_t.device).long()
        t_prev = torch.as_tensor(t_prev, device=x_t.device).long()
        bshape = (-1,) + (1,) * (x_t.ndim - 1)

        def at(table, ts):
            return table.to(x_t.device)[ts].reshape(bshape).to(x_t.dtype)

        sd_t, sd_p = at(self.drift_schedule, t), at(self.drift_schedule, t_prev)
        sig_t, sig_p = at(self.sigmas, t), at(self.sigmas, t_prev)
        x0_hat = x_t - sd_t * pred_drift - sig_t * pred_noise
        carry, c = self.posterior_coeffs(sig_t, sig_p, eta)
        return x0_hat + sd_p * pred_drift + carry * pred_noise + c * z

    def step(self, state: SamplerState, predict_fn: PredictFn) -> None:
        """One sampler step, the scan body: the row at the state's step
        index, the nets, the reverse step into ``state.x``, index + 1."""
        row = state.row()
        pred_drift, pred_noise = predict_fn(state.x, row)
        state.advance(self.reverse_step(state.x, row, pred_drift, pred_noise, state.z))

    def reverse_ddpm(self, mu: torch.Tensor, predict_fn: PredictFn,
                     eta: Optional[float] = None, sample_steps: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None):
        """Reverse sampler over the strided grid, one eager ``step`` per row.
        ``init_noise`` ([B,H,W,1]) and ``step_noise`` (one tensor per step)
        replace draws from ``generator``; the draw order is init first, then
        one per step."""
        state = SamplerState(mu, self.coeff_table(sample_steps, eta, mu.device))
        return run_steps(self, state, mu, lambda: self.step(state, predict_fn), generator,
                         init_noise, step_noise)

    def reverse_ode(self, mu: torch.Tensor, predict_fn: PredictFn, **kwargs):
        """The deterministic sampler: ``reverse_ddpm`` at eta=0."""
        return self.reverse_ddpm(mu, predict_fn, eta=0.0, **kwargs)
