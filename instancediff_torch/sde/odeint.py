"""Adaptive Dormand-Prince (RK45) integration on torch tensors: the
controller and dense output of ``jax.experimental.ode.odeint``, which the
JAX package's ``IRSDE.ode_sampler`` calls.

The state stays on its device; each step's error ratio comes to the host,
which accepts or rejects the step. Times, step sizes and the controller's
arithmetic are float32 scalars on the host (``np.float32``), as JAX keeps
them in float32 on its device, so both take the same steps up to the
roundoff of the norms and sums."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

F32 = np.float32

# Dormand-Prince 5(4) tableau (JAX's ``runge_kutta_step``)
ALPHA = np.array([1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], F32)
BETA = [
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
C_ERROR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085, 125 / 192 - 451 / 720,
           -2187 / 6784 - -12231 / 42400, 11 / 84 - 649 / 6300, -1.0 / 60.0]
# the midpoint of the dense output (JAX's ``interp_fit_dopri``)
C_MID = [6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
         -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
         -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float (exact in a float32 op)."""
    return float(F32(v))


def _combine(coeffs, k):
    """sum_j coeffs[j] k[j] in float32, term by term (zero terms skipped:
    they add exact zeros)."""
    acc = None
    for c, kj in zip(coeffs, k):
        if c == 0:
            continue
        term = _f32(c) * kj
        acc = term if acc is None else acc + term
    return acc


def _norm(x: torch.Tensor) -> F32:
    return F32(torch.linalg.vector_norm(x).item())


def initial_step_size(func, t0: F32, y0, order: int, rtol: float, atol: float, f0) -> F32:
    """Hairer, Norsett and Wanner's first step (Solving ODEs I, II.4)."""
    scale = _f32(atol) + torch.abs(y0) * _f32(rtol)
    d0, d1 = _norm(y0 / scale), _norm(f0 / scale)
    h0 = F32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else F32(0.01) * d0 / d1
    f1 = func(y0 + float(h0) * f0, F32(t0 + h0))
    d2 = _norm((f1 - f0) / scale) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(F32(1e-6), h0 * F32(1e-3))
    else:
        h1 = (F32(0.01) / max(d1, d2)) ** F32(1.0 / (order + 1.0))
    return F32(min(F32(100.0) * h0, h1))


def runge_kutta_step(func, y0, f0, t0: F32, dt: F32):
    """One Dormand-Prince step: (y1, f1, error estimate, the 7 stages)."""
    k = [f0]
    for i in range(1, 7):
        ti = F32(t0 + dt * ALPHA[i - 1])
        k.append(func(y0 + float(dt) * _combine(BETA[i - 1], k), ti))
    y1 = float(dt) * _combine(C_SOL, k) + y0
    return y1, k[-1], float(dt) * _combine(C_ERROR, k), k


def mean_error_ratio(err, rtol: float, atol: float, y0, y1) -> F32:
    tol = _f32(atol) + _f32(rtol) * torch.maximum(torch.abs(y0), torch.abs(y1))
    return F32(torch.sqrt(torch.mean((err / tol) ** 2)).item())


def optimal_step_size(last_step: F32, ratio: F32, safety=0.9, ifactor=10.0, dfactor=0.2,
                      order=5.0) -> F32:
    if ratio == 0:
        return F32(last_step * F32(ifactor))
    dfactor = 1.0 if ratio < 1 else dfactor
    factor = min(F32(ifactor), max(ratio ** F32(-1.0 / order) * F32(safety), F32(dfactor)))
    return F32(last_step * factor)


def interp_fit_dopri(y0, y1, k, dt: F32) -> list:
    """The quartic through the step (coefficients, highest power first)."""
    y_mid = y0 + float(dt) * _combine(C_MID, k)
    dy0, dy1, h = k[0], k[-1], float(dt)
    a = -2.0 * h * dy0 + 2.0 * h * dy1 - 8.0 * y0 - 8.0 * y1 + 16.0 * y_mid
    b = 5.0 * h * dy0 - 3.0 * h * dy1 + 18.0 * y0 + 14.0 * y1 - 32.0 * y_mid
    c = -4.0 * h * dy0 + h * dy1 - 11.0 * y0 - 5.0 * y1 + 16.0 * y_mid
    return [a, b, c, h * dy0, y0]


def polyval(coeffs, x: F32):
    out = coeffs[0]
    for c in coeffs[1:]:
        out = out * float(x) + c
    return out


def odeint(func: Callable, y0: torch.Tensor, t0: float, t1: float, rtol: float = 1.4e-8,
           atol: float = 1.4e-8) -> Tuple[torch.Tensor, Dict[str, int]]:
    """y(t1) of dy/dt = func(y, t), y(t0) = y0, t1 > t0: adaptive steps
    until one ends at or past t1, then the value at t1 from the last step's
    dense output (it is interpolated, not stepped onto); a non-finite
    first step or error estimate raises ``FloatingPointError``. ``func(y, t)``
    takes ``t`` as an ``np.float32``. Returns (y(t1), counts): function
    evaluations ``nfev``, ``accepted`` and ``rejected`` steps."""
    t, target = F32(t0), F32(t1)
    f = func(y0, t)
    nfev = 1
    dt = initial_step_size(func, t, y0, 4, rtol, atol, f)
    nfev += 1
    if not np.isfinite(dt):
        raise FloatingPointError(f"odeint: initial step {dt} (the derivative is not finite)")
    y, last_t, coeffs = y0, t, [y0] * 5
    accepted = rejected = 0
    while t < target and dt > 0:
        next_y, next_f, err, k = runge_kutta_step(func, y, f, t, dt)
        nfev += 6
        ratio = mean_error_ratio(err, rtol, atol, y, next_y)
        if not np.isfinite(ratio):
            raise FloatingPointError(f"odeint: error ratio {ratio} at t={t}, dt={dt}")
        new_dt = optimal_step_size(dt, ratio)
        if ratio <= 1.0:
            coeffs = interp_fit_dopri(y, next_y, k, dt)
            y, f, last_t, t = next_y, next_f, t, F32(t + dt)
            accepted += 1
        else:
            rejected += 1
        dt = new_dt
    rel = F32((target - last_t) / (t - last_t))
    return polyval(coeffs, rel), {"nfev": nfev, "accepted": accepted, "rejected": rejected}
