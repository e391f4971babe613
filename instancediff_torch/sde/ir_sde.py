"""The mean-reverting IR-SDE (port of ``instancediff_tpu/sde/ir_sde.py``).

    theta_t:     per-step reversion rate (constant, linear or cosine)
    sigma_t^2  = 2 max_sigma^2 theta_t
    thetabar_t = cumsum(theta), thetabar_0 = 0
    dt         = -log(eps) / thetabar_T
    sigmabar_t = sqrt(max_sigma^2 (1 - exp(-2 thetabar_t dt)))
    forward:     x_t ~ N(mu + (x0 - mu) exp(-thetabar_t dt), sigmabar_t^2)
    score      = -noise / sigmabar_t
    reverse:     x <- x - [theta_t (mu - x) - sigma_t^2 score] dt
                 (+ sigma_t sqrt(dt) z while t > 1)

The tables are built in float64 numpy and kept in float32, cast where JAX
casts them. The samplers run eagerly, one ``noise_fn(x, t[B])`` per step
(any closure, as in JAX) on ``x``'s device, and take their random draws as
tensors (``init_noise``, ``step_noise``) or from a ``torch.Generator``:
torch cannot draw JAX's threefry bits. ``ode_sampler`` integrates the
probability-flow ODE with the port's own adaptive Dormand-Prince
(``odeint.py``), the controller and dense output of the
``jax.experimental.ode.odeint`` that JAX calls."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .odeint import odeint

# noise_fn(x, t) -> the predicted standard noise; t: [B] int32 timesteps
NoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class IRSDE:
    def __init__(self, max_sigma: float = 0.4, T: int = 100, schedule: str = "cosine",
                 eps: float = 0.01):
        self.T = int(T)
        self.max_sigma = float(max_sigma) / 255.0 if max_sigma >= 1 else float(max_sigma)
        self.schedule_name = schedule
        if schedule == "constant":
            thetas = np.ones(T + 1, dtype=np.float64)
        elif schedule == "linear":
            scale = 1000.0 / (T + 1)
            thetas = np.linspace(scale * 1e-4, scale * 0.02, T + 1, dtype=np.float64)
        elif schedule == "cosine":
            s, steps = 0.008, T + 2
            x = np.linspace(0, steps, steps + 1, dtype=np.float64)
            ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
            thetas = 1.0 - (ac / ac[0])[1:-1]
        else:
            raise ValueError(f"unknown IR-SDE schedule '{schedule}'")
        thetas_cum = np.cumsum(thetas) - thetas[0]  # thetabar_0 = 0
        self.dt = float(-np.log(eps) / thetas_cum[-1])
        self.thetas = torch.from_numpy(thetas.astype(np.float32))
        self.thetas_cum = torch.from_numpy(thetas_cum.astype(np.float32))
        sigma_bars = np.sqrt(self.max_sigma**2 * (1.0 - np.exp(-2.0 * thetas_cum * self.dt)))
        self.sigma_bars = torch.from_numpy(sigma_bars.astype(np.float32))
        self.sigmas = torch.from_numpy(
            np.sqrt(np.float32(2.0 * self.max_sigma**2) * thetas.astype(np.float32)))

    # ------------------------------------------------------------ per-sample

    def _at(self, table: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``table[t]`` shaped [B,1,...] like ``x``, on its device (float32)."""
        t = torch.as_tensor(t).long().reshape(-1).cpu()
        return table[t].reshape((-1,) + (1,) * (x.ndim - 1)).to(x.device)

    def mu_bar(self, x0: torch.Tensor, mu: torch.Tensor, t) -> torch.Tensor:
        """The forward marginal's mean at the timesteps ``t`` [B]."""
        decay = torch.exp(-self._at(self.thetas_cum, t, x0) * self.dt).to(x0.dtype)
        return mu + (x0 - mu) * decay

    def forward_diffusion(self, x0: torch.Tensor, mu: torch.Tensor,
                          t: Optional[torch.Tensor] = None,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
        """``(t, x_t, noise)``: t ~ U{1..T} per sample, shaped [B,1,...],
        x_t drawn from the closed-form marginal with standard noise
        ``noise``. ``t`` ([B] ints) and ``noise`` replace draws from
        ``generator`` (t first, then the noise)."""
        B = x0.shape[0]
        if t is None:
            t = torch.randint(1, self.T + 1, (B,), generator=generator, device=x0.device)
        t = torch.as_tensor(t, device=x0.device).long().reshape(B)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        noise = noise.to(x0.device, x0.dtype)
        x_t = self.mu_bar(x0, mu, t) + self._at(self.sigma_bars, t, x0).to(x0.dtype) * noise
        return t.reshape((B,) + (1,) * (x0.ndim - 1)), x_t, noise

    def score_from_noise(self, noise_hat: torch.Tensor, t) -> torch.Tensor:
        sbar = self._at(self.sigma_bars, t, noise_hat)
        return -noise_hat / torch.clamp(sbar, min=1e-12).to(noise_hat.dtype)

    def reverse_optimum_step(self, x_t: torch.Tensor, x0: torch.Tensor, t) -> torch.Tensor:
        """The posterior mean of x_{t-1} given x_t and the true x0 (both
        relative to mu: the caller passes residuals x - mu)."""
        t = torch.as_tensor(t).long().reshape(-1).cpu()

        def at(table, tt):
            return self._at(table, tt, x_t).to(x_t.dtype)

        A = torch.exp(-at(self.thetas, t) * self.dt)
        C = torch.exp(-at(self.thetas_cum, t - 1) * self.dt)
        sbar_t, sbar_p = at(self.sigma_bars, t), at(self.sigma_bars, t - 1)
        ratio = A * sbar_p**2 / torch.clamp(sbar_t**2, min=1e-12)
        term1 = ratio * x_t
        term2 = C * (1.0 - A * A * sbar_p**2 / torch.clamp(sbar_t**2, min=1e-12)) * x0
        return term1 + term2

    # ------------------------------------------------------------ samplers

    def _coeffs(self, t: int) -> tuple:
        """(theta_t, sigma_t^2, 1/max(sigmabar_t, 1e-12) as the divisor) as
        float32 values, computed as JAX computes them."""
        theta = np.float32(self.thetas[t])
        sigma2 = np.float32(np.float32(2.0 * self.max_sigma**2) * theta)
        sbar = max(np.float32(self.sigma_bars[t]), np.float32(1e-12))
        return theta, sigma2, sbar

    def _init_state(self, mu, init_noise, generator):
        if init_noise is None:
            init_noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                                     dtype=mu.dtype)
        return mu + self.max_sigma * init_noise.to(mu.device, mu.dtype)

    def _predict(self, noise_fn: NoiseFn, x, t: int) -> torch.Tensor:
        t_b = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        return noise_fn(x, t_b).to(x.dtype)

    def reverse_sde(self, mu: torch.Tensor, noise_fn: NoiseFn, stochastic: bool = True,
                    return_states: bool = False, init_noise: Optional[torch.Tensor] = None,
                    step_noise: Optional[Sequence[torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None):
        """The T-step reverse SDE from x_T = mu + max_sigma * init_noise,
        t = T..1. ``step_noise[i]`` is the z of step i (t = T - i); no noise
        is added at t = 1, and none at all without ``stochastic``. Draws
        from ``generator``: init first, then one per step. With
        ``return_states``, also the [T, ...] stack of each step's result."""
        x = self._init_state(mu, init_noise, generator)
        states = []
        for i, t in enumerate(range(self.T, 0, -1)):
            theta, sigma2, sbar = self._coeffs(t)
            score = -self._predict(noise_fn, x, t) / float(sbar)
            drift = float(theta) * (mu - x) * self.dt
            x_next = x - (drift - float(sigma2) * score * self.dt)
            if stochastic:
                z = (torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
                     if step_noise is None else step_noise[i].to(x.device, x.dtype))
                if t > 1:
                    x_next = x_next + float(np.sqrt(sigma2 * np.float32(self.dt))) * z
            x = x_next
            if return_states:
                states.append(x)
        return (x, torch.stack(states)) if return_states else x

    def reverse_ode(self, mu: torch.Tensor, noise_fn: NoiseFn, return_states: bool = False,
                    init_noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """The probability-flow loop: half the diffusion term, no noise."""
        x = self._init_state(mu, init_noise, generator)
        states = []
        for t in range(self.T, 0, -1):
            theta, sigma2, sbar = self._coeffs(t)
            score = -self._predict(noise_fn, x, t) / float(sbar)
            x = x - (float(theta) * (mu - x) - float(np.float32(0.5) * sigma2) * score) \
                * self.dt
            if return_states:
                states.append(x)
        return (x, torch.stack(states)) if return_states else x

    def ode_sampler(self, x_T: torch.Tensor, mu: torch.Tensor, noise_fn: NoiseFn,
                    rtol: float = 1e-5, atol: float = 1e-5, eps: float = 1e-3,
                    return_info: bool = False):
        """The probability-flow ODE solved adaptively in s = T - t from 0 to
        T - eps: theta interpolated linearly in continuous t, the net called
        at the rounded step clipped to [1, T]. With ``return_info``, also
        the solver's counts (``nfev``, ``accepted``, ``rejected``)."""
        thetas = self.thetas.numpy()
        grid = np.arange(self.T + 1, dtype=np.float32)
        two_sigma2 = np.float32(2.0 * self.max_sigma**2)

        def dx_ds(x, s):
            t_cont = np.float32(self.T) - s
            t_idx = int(np.clip(np.round(t_cont), 1, self.T))
            sbar = max(np.float32(self.sigma_bars[t_idx]), np.float32(1e-12))
            score = -self._predict(noise_fn, x, t_idx) / float(sbar)
            theta = _interp(t_cont, grid, thetas)
            half_sigma2 = np.float32(0.5) * np.float32(two_sigma2 * theta)
            return -(float(theta) * (mu - x) - float(half_sigma2) * score) * self.dt

        x0, info = odeint(dx_ds, x_T, 0.0, np.float32(self.T) - np.float32(eps), rtol=rtol,
                          atol=atol)
        return (x0, info) if return_info else x0


def _interp(x: np.float32, xp: np.ndarray, fp: np.ndarray) -> np.float32:
    """``jnp.interp`` of one float32 point (constant beyond the ends)."""
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    return np.float32(fp[i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (fp[i] - fp[i - 1]))
