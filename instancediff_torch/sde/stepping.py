"""The sampler loop shared by ``DriftSDE`` and ``DDPMSDE``: the port's
counterpart of the JAX samplers' ``lax.scan``.

A step reads its coefficients from a per-call table on the sampler's device
(one float32 row per grid step, ``coeff_table`` of either SDE) through a
step index that lives on the device too, and advances that index itself,
the way ``lax.scan`` feeds its ``xs``. No Python number in a step depends on
the timestep, so one step body serves both ways of running it: a Python
loop calls it (the CPU, and ``compiled=False`` on CUDA), or the engine
captures it once in a CUDA graph and replays it (``models/engine.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.profiler import record_function


class SamplerState:
    """What a sampler step reads and writes, at fixed addresses on mu's
    device: the state ``x``, the step's fresh noise ``z`` (both like mu),
    the step index ``idx`` ([1] int64) and the coefficient ``table``."""

    def __init__(self, mu: torch.Tensor, table: torch.Tensor):
        self.table = table
        self.x = torch.empty_like(mu)
        self.z = torch.empty_like(mu)
        self.idx = torch.zeros(1, dtype=torch.int64, device=mu.device)

    def row(self) -> torch.Tensor:
        """This step's coefficient row, [k] float32, read on the device."""
        return self.table.index_select(0, self.idx)[0]

    def advance(self, x_next: torch.Tensor) -> None:
        self.x.copy_(x_next)
        self.idx.add_(1)


def run_steps(sde, state: SamplerState, mu: torch.Tensor, run_step: Callable[[], None],
              generator: Optional[torch.Generator] = None,
              init_noise: Optional[torch.Tensor] = None,
              step_noise: Optional[Sequence[torch.Tensor]] = None, sp=None) -> torch.Tensor:
    """Start ``state`` at ``sde.init_state`` and call ``run_step`` once per
    table row (one eager step, or one graph replay); returns ``state.x``.
    ``init_noise`` ([B,H,W,1]) and ``step_noise`` (one tensor per step)
    replace draws from ``generator``; the draw order is init first, then one
    per step, each drawn before its step (outside a captured graph, so a
    replay consumes the generator exactly as the eager loop does). With
    ``sp`` (a ``parallel.spatial.SpatialGroup``) mu and the state are this
    rank's rows of the images: every rank draws (or is given) the whole
    images' noise, from a generator seeded alike on every rank, and takes
    its own rows, so the ranks together draw what one process draws."""
    n_steps = state.table.shape[0]
    if step_noise is not None and len(step_noise) != n_steps:
        raise ValueError(f"step_noise has {len(step_noise)} entries for "
                         f"{n_steps} sampler steps")
    sharded = sp is not None and sp.world > 1
    full = (mu.shape[0], mu.shape[1] * sp.world, *mu.shape[2:]) if sharded else mu.shape

    def own(z):
        return sp.rows(z) if sharded else z

    if init_noise is None:
        eps = torch.randn(full, generator=generator, device=mu.device, dtype=mu.dtype)
    else:
        eps = init_noise.to(mu.device, mu.dtype)
    state.x.copy_(sde.init_state(mu, own(eps), state.table))
    state.idx.zero_()
    z_full = torch.empty(full, device=mu.device, dtype=mu.dtype) if sharded else state.z
    for i in range(n_steps):
        with record_function("sampler_step"):
            if step_noise is None:
                z_full.normal_(generator=generator)
                state.z.copy_(own(z_full))
            else:
                state.z.copy_(own(step_noise[i].to(mu.device)))
            run_step()
    return state.x
