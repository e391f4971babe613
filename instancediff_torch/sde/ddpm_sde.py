"""Conditional DDPM: the forward diffusion the train step draws and the
reverse sampler (port of ``instancediff_tpu/sde/ddpm_sde.py``).

A variance-preserving DDPM on the clean image, x_t = sqrt(abar_t) x0 +
s sqrt(1 - abar_t) eps with s = ``max_sigma``; the degraded input conditions
the net, not the noising. The JAX sampler is one ``lax.scan``; here its body
is ``DDPMSDE.step``, which reads a per-call coefficient table on the device
(``stepping.py``), and every random draw is injectable, as in
``DriftSDE.reverse_ddpm``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .schedules import strided_sampling_grid
from .stepping import SamplerState, run_steps

# predict_fn(x_t, row) -> eps_hat; row is the step's coefficient row, row[0]
# its timestep t
NoisePredictFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_cosine_alphas_bar(T: int, s: float = 0.008) -> torch.Tensor:
    """The improved-DDPM cosine alpha-bar, [T+1] float32 with abar[0] = 1,
    in float64 numpy first as in the JAX package."""
    t = np.arange(T + 1, dtype=np.float64)
    f = np.cos((t / T + s) / (1 + s) * np.pi / 2.0) ** 2
    abar = np.clip(f / f[0], 1e-8, 1.0)
    return torch.from_numpy(abar.astype(np.float32))


class DDPMSDE:
    """The ``cosine_alpha`` schedule table plus the strided DDIM(eta)
    reverse step. The alpha-bar table stays on the CPU in float32; a sampler
    call turns the entries its grid needs into a coefficient table on its
    device, in float32 arithmetic as in the JAX step."""

    # the columns of ``coeff_table``
    COLUMNS = ("t", "t_prev", "sa_t", "s_sig_t", "sa_p", "s_carry", "s_noise")

    def __init__(self, T: int = 100, max_sigma: float = 1.0, schedule: str = "cosine_alpha"):
        if schedule != "cosine_alpha":
            raise ValueError(f"unsupported ddpm schedule '{schedule}'")
        self.T = int(T)
        self.max_sigma = float(max_sigma)
        self.eta = 1.0  # the sampler's default eta
        self.alphas_bar = make_cosine_alphas_bar(self.T)

    def forward_diffusion(self, x0: torch.Tensor, mu: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          t: Optional[torch.Tensor] = None,
                          eps: Optional[torch.Tensor] = None):
        """``(t, x_t, eps)``: t ~ U{1..T} per sample, shaped [B,1,1,1], eps ~
        N(0, I) like x0, x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) s eps.
        ``mu`` is unused (the condition enters the net). ``t`` ([B] ints) and
        ``eps`` replace draws from ``generator`` (t first, then the noise)."""
        B = x0.shape[0]
        if t is None:
            t = torch.randint(1, self.T + 1, (B,), generator=generator, device=x0.device)
        t = torch.as_tensor(t, device=x0.device).long().reshape(B)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        eps = eps.to(x0.device, x0.dtype)
        bshape = (B,) + (1,) * (x0.ndim - 1)
        abar = self.alphas_bar.to(x0.device)[t].reshape(bshape).to(x0.dtype)
        x_t = torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * self.max_sigma * eps
        return t.reshape(bshape), x_t, eps

    def coeff_table(self, sample_steps: Optional[int] = None, eta: Optional[float] = None,
                    device="cpu") -> torch.Tensor:
        """[n_steps, 7] float32 on ``device``, one row per step t -> t_prev of
        the strided grid in sampling order, columns ``COLUMNS``:
        ``(t, t_prev, sqrt(abar_t), s*sqrt(1-abar_t), sqrt(abar_p), s*carry,
        s*sigma)`` with sigma^2 = eta^2 (1-abar_p)/(1-abar_t) (1-abar_t/abar_p),
        clipped to [0, 1-abar_p] and sigma = 0 at t_prev = 0; carry =
        sqrt(1-abar_p-sigma^2); s = ``max_sigma``; ``eta`` default 1."""
        eta_v = self.eta if eta is None else float(eta)
        t_hi, t_lo = strided_sampling_grid(self.T, sample_steps)
        t, tp = torch.tensor(t_hi), torch.tensor(t_lo)
        abar_t, abar_p = self.alphas_bar[t], self.alphas_bar[tp]
        s = torch.tensor(self.max_sigma, dtype=torch.float32)
        sigma2 = (eta_v**2 * (1.0 - abar_p) / (1.0 - abar_t) * (1.0 - abar_t / abar_p))
        sigma2 = torch.clamp(sigma2, torch.zeros_like(abar_p), 1.0 - abar_p)
        noise = torch.where(tp > 0, torch.sqrt(sigma2), torch.zeros_like(sigma2))
        carry = torch.sqrt(torch.clamp(1.0 - abar_p - sigma2, min=0.0))
        table = torch.stack([t.float(), tp.float(), torch.sqrt(abar_t),
                             s * torch.sqrt(1.0 - abar_t), torch.sqrt(abar_p), s * carry,
                             s * noise], dim=1)
        return table.to(device)

    def init_state(self, mu: torch.Tensor, eps: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """x_T = s * eps: pure noise (mu conditions the net, not the state)."""
        return eps * self.max_sigma

    def reverse_step(self, x: torch.Tensor, row: torch.Tensor, eps_hat: torch.Tensor,
                     z: torch.Tensor, clip_x0: bool = True) -> torch.Tensor:
        """One DDIM(eta) step t -> t_prev with the coefficients of ``row``
        (eta=1 on the consecutive grid is the ancestral DDPM step).
        ``clip_x0`` clamps the x0 estimate to [-1, 1] and re-derives eps
        from it."""
        _, _, sa_t, s_sig_t, sa_p, s_carry, s_noise = row.unbind()
        eps_hat = eps_hat.to(x.dtype)
        x0_hat = (x - s_sig_t * eps_hat) / sa_t
        if clip_x0:
            x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
            eps_hat = (x - sa_t * x0_hat) / s_sig_t
        return sa_p * x0_hat + s_carry * eps_hat + s_noise * z

    def step(self, state: SamplerState, predict_fn: NoisePredictFn, clip_x0: bool = True) -> None:
        """One sampler step, the scan body: the row at the state's step
        index, the net, the reverse step into ``state.x``, index + 1."""
        row = state.row()
        state.advance(self.reverse_step(state.x, row, predict_fn(state.x, row), state.z,
                                        clip_x0))

    def reverse_ddpm(self, mu: torch.Tensor, predict_fn: NoisePredictFn,
                     sample_steps: Optional[int] = None, eta: Optional[float] = None,
                     clip_x0: bool = True, generator: Optional[torch.Generator] = None,
                     init_noise: Optional[torch.Tensor] = None,
                     step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Sample from pure noise x_T = s * eps, conditioned through the net,
        over the strided grid (``eta`` default 1), one eager ``step`` per
        row. ``init_noise`` ([B,H,W,1]) and ``step_noise`` (one tensor per
        step) replace draws from ``generator``; the draw order is init
        first, then one per step."""
        state = SamplerState(mu, self.coeff_table(sample_steps, eta, mu.device))
        return run_steps(self, state, mu, lambda: self.step(state, predict_fn, clip_x0),
                         generator, init_noise, step_noise)
