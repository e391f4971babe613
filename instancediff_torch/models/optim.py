"""The engines' optimizer, learning-rate schedule and EMA (port of
``make_adam``, ``cosine_annealing_lr`` and ``_ema_update`` in
``instancediff_tpu/models/drift_model.py``)."""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

EMA_BETA, EMA_EVERY, EMA_AFTER = 0.995, 10, 100


def make_adam(params: Iterable[torch.nn.Parameter], lr: float, beta1: float, beta2: float,
              weight_decay: float) -> torch.optim.Adam:
    """Adam with coupled L2 (``weight_decay * p`` added to the gradient
    before the moments): optax's ``add_decayed_weights`` then
    ``scale_by_adam(eps=1e-8)`` then the learning rate, as JAX chains them.
    The learning rate is set per epoch through ``param_groups``."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                            weight_decay=weight_decay)


def cosine_annealing_lr(epoch, nepoch, lr0, eta_min) -> float:
    """torch's ``CosineAnnealingLR(T_max=nepoch)`` stepped once per epoch, in
    closed form."""
    return float(eta_min + (lr0 - eta_min) * (1 + np.cos(np.pi * epoch / nepoch)) / 2.0)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def ema_update(ema: torch.nn.Module, net: torch.nn.Module, step: int, beta: float = EMA_BETA,
               update_every: int = EMA_EVERY, update_after: int = EMA_AFTER) -> None:
    """ema_pytorch's EMA, applied after the step counter increments: every
    ``update_every`` steps the shadow is copied from the net while
    ``step < update_after`` and decayed toward it after (``beta e +
    (1 - beta) p``); other steps leave it as it is."""
    ema_update_tensors(list(ema.parameters()), list(net.parameters()), step, beta,
                       update_every, update_after)


@torch.no_grad()
def ema_update_tensors(shadows, params, step: int, beta: float = EMA_BETA,
                       update_every: int = EMA_EVERY, update_after: int = EMA_AFTER) -> None:
    """``ema_update`` on lists of tensors: the shadows ``shadows`` of
    ``params``, elementwise (an FSDP rank updates its shards alone)."""
    if step % update_every:
        return
    if step < update_after:
        torch._foreach_copy_(shadows, params)
    else:
        torch._foreach_mul_(shadows, beta)
        torch._foreach_add_(shadows, params, alpha=1.0 - beta)
