"""Diffusion schedule families (port of ``instancediff_tpu/sde/schedules.py``).

Tables are computed in float64 numpy and stored as float32 torch tensors, the
same arithmetic as the JAX package, so both give identical [T+1] tables."""

from __future__ import annotations

import numpy as np
import torch

SCHEDULE_NAMES = ("linear", "cosine", "sigmoid", "constant")


def make_schedule(name: str, T: int, sigmoid_scale: float = 6.0) -> torch.Tensor:
    """Monotone level schedule s[t], s[0]=0, s[T]=1, shape [T+1] float32 (CPU)."""
    t = np.arange(T + 1, dtype=np.float64)
    if name == "linear":
        s = t / T
    elif name == "cosine":
        s = (1.0 - np.cos(t * np.pi / T)) / 2.0
    elif name == "sigmoid":
        a = sigmoid_scale
        raw = 1.0 / (1.0 + np.exp(-a * (2.0 * t / T - 1.0)))
        lo = 1.0 / (1.0 + np.exp(a))
        hi = 1.0 / (1.0 + np.exp(-a))
        s = (raw - lo) / (hi - lo)
    elif name == "constant":
        s = np.ones_like(t)
        s[0] = 0.0
    else:
        raise ValueError(f"unknown schedule '{name}' (choose from {SCHEDULE_NAMES})")
    s[0], s[-1] = 0.0, 1.0
    return torch.from_numpy(s.astype(np.float32))


def schedule_increment(schedule: torch.Tensor) -> torch.Tensor:
    """Per-step increments ds[t] = s[t] - s[t-1], ds[0] = 0, shape [T+1]."""
    return torch.diff(schedule, prepend=schedule[:1])


def strided_sampling_grid(T: int, sample_steps=None):
    """Reverse-sampler timestep grid ``(t_hi, t_lo)``: lists of ints running
    T -> 0 over ``sample_steps`` (or all T) strided posterior pairs."""
    n_steps = T if sample_steps is None else int(sample_steps)
    grid = np.unique(np.round(np.linspace(0, T, n_steps + 1)).astype(np.int32))
    t_hi = [int(v) for v in grid[1:][::-1]]
    t_lo = [int(v) for v in grid[:-1][::-1]]
    return t_hi, t_lo
