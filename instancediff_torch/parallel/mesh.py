"""ZeRO-style parameter sharding over a dp x fsdp grid of processes (the
FSDP half of ``instancediff_tpu/parallel/mesh.py``).

The JAX package places each train-state leaf on a ``("dp", "fsdp")`` mesh
with ``shard_params_fsdp`` (the largest dimension the fsdp axis divides is
split; ``_fsdp_spec``) and lets XLA gather the parameters for the forward
and reduce-scatter the gradients. Here the mesh is a grid of process
groups (``Grid``; rank = dp index x fsdp + fsdp index, the order of JAX's
device array reshaped to the mesh), and the step is written out
(``FSDPState``, which ``SamplingEngine.shard_fsdp`` installs):

- the batch is split over dp and replicated over fsdp, as JAX shards it
  along ``"dp"`` only;
- before the forward every parameter is gathered whole over fsdp;
- after the backward the gradients are averaged over dp, then over fsdp
  each rank keeps the mean of its own shard (NCCL: ``reduce_scatter_tensor``;
  gloo has no reduce-scatter, so an all-reduce and a slice there);
- Adam and the EMA update only this rank's shard of each parameter, of its
  two moments and of its EMA shadow: both are elementwise, so shard by shard
  equals whole;
- then the whole parameters are released, and between steps each rank
  holds its shards only.

``.state`` files are gathered and written by rank 0 with the bytes of an
unsharded run (``SamplingEngine.save_training_state``).
"""

from __future__ import annotations

import types
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import TIMEOUT, all_reduce_mean_, rank, world_size

# XLA SPMD partitioner fault (convolution_handler.cc "ShapeUtil::Compatible(
# shard_shape, sharded_conv->shape())"): an fsdp-sharded ConvTranspose kernel
# inside JAX's vmapped dual-net train step crashes partitioning, so the JAX
# package replicates the UNet's `up_*` leaves. The port needs no such
# workaround; it keeps the pattern so that its shard layout is JAX's.
FSDP_REPLICATE_PATTERNS = ("up_",)


class Grid:
    """The world's ranks as a dp x fsdp grid (rank = d * fsdp + f): this
    rank's ``dp_rank`` and ``fsdp_rank``, the ``fsdp_group`` of its row (the
    ranks that share one dp slice of the batch and split the parameters) and
    the ``dp_group`` of its column (the ranks holding the same shards, each
    with its own slice of the batch). Every rank builds every group, in one
    order, as ``dist.new_group`` requires."""

    def __init__(self, dp: int, fsdp: int):
        world = world_size()
        if dp * fsdp != world:
            raise ValueError(f"a {dp} x {fsdp} grid over a world of {world}")
        self.dp, self.fsdp = dp, fsdp
        self.dp_rank, self.fsdp_rank = divmod(rank(), fsdp)
        self.backend = dist.get_backend() if dist.is_initialized() else "gloo"
        for d in range(dp):
            g = dist.new_group([d * fsdp + f for f in range(fsdp)], timeout=TIMEOUT)
            if d == self.dp_rank:
                self.fsdp_group = g
        for f in range(fsdp):
            g = dist.new_group([d * fsdp + f for d in range(dp)], timeout=TIMEOUT)
            if f == self.fsdp_rank:
                self.dp_group = g


def fsdp_spec(shape: Sequence[int], size: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is split along over ``size`` ranks
    (JAX's ``_fsdp_spec``): the largest one that ``size`` divides, the first
    of equal ones; None (replicated) for a scalar, a grid of one, or a shape
    that nothing divides."""
    if size == 1 or len(shape) == 0:
        return None
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % size == 0 and shape[d] >= size:
            return d
    return None


def leaf_spec(name: str, shape: Sequence[int], size: int) -> Optional[int]:
    """``fsdp_spec``, with the leaves of a module named in
    ``FSDP_REPLICATE_PATTERNS`` replicated."""
    if any(pat in name for pat in FSDP_REPLICATE_PATTERNS):
        return None
    return fsdp_spec(shape, size)


def _shard(t: torch.Tensor, dim: Optional[int], grid: Grid) -> torch.Tensor:
    if dim is None:
        return t.detach().clone()
    n = t.shape[dim] // grid.fsdp
    return t.detach().narrow(dim, grid.fsdp_rank * n, n).clone()


def _gather_all(shards: List[torch.Tensor], dims: List[Optional[int]],
                grid: Grid) -> List[torch.Tensor]:
    """Each shard made whole: a split one from every fsdp rank's shard,
    concatenated along its split dimension (one all-gather per dtype of all
    the split shards flattened into one buffer, staged through the host for
    CUDA tensors under gloo); a replicated one copied."""
    out = [s.clone() if d is None or grid.fsdp == 1 else None
           for s, d in zip(shards, dims)]
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (s, d) in enumerate(zip(shards, dims)):
        if out[i] is None:
            by_dtype.setdefault(s.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        device = flat.device
        if grid.backend == "gloo" and device.type != "cpu":
            flat = flat.cpu()
        parts = [torch.empty_like(flat) for _ in range(grid.fsdp)]
        dist.all_gather(parts, flat, group=grid.fsdp_group)
        sizes = [shards[i].numel() for i in idx]
        pieces = [torch.split(p.to(device), sizes) for p in parts]
        for j, i in enumerate(idx):
            out[i] = torch.cat([pc[j].view(shards[i].shape) for pc in pieces], dim=dims[i])
    return out


def shard_params_fsdp(named: Dict[str, torch.Tensor], grid: Grid) -> Dict[str, tuple]:
    """Each named tensor as (this rank's shard, its split dimension or
    None): ``leaf_spec``'s layout over ``grid``'s fsdp ranks."""
    out = {}
    for name, t in named.items():
        dim = leaf_spec(name, t.shape, grid.fsdp)
        out[name] = (_shard(t, dim, grid), dim)
    return out


def gather_params(shards: Dict[str, tuple], grid: Grid) -> Dict[str, torch.Tensor]:
    """``shard_params_fsdp``'s inverse: every tensor whole on every rank."""
    names = list(shards)
    return dict(zip(names, _gather_all([shards[n][0] for n in names],
                                       [shards[n][1] for n in names], grid)))


class FSDPState:
    """An engine's train state sharded over ``grid`` (see the module's
    docstring): for each trained net, its parameters' shards (the leaves of
    a new Adam, whose moments are then shards too; moments the engine's
    optimizer held already are sharded with them) and its EMA shadow's
    shards. ``gather_()`` makes the nets (and the EMA nets) whole,
    ``release_()`` frees them; ``held_bytes()`` counts what a rank keeps
    between steps."""

    def __init__(self, engine, grid: Grid):
        from ..models.optim import make_adam

        self.engine, self.grid = engine, grid
        self.dims: Dict[str, List[Optional[int]]] = {}
        self.shards: Dict[str, List[torch.nn.Parameter]] = {}
        self.ema: Dict[str, List[torch.Tensor]] = {}
        for key, (_, ema_key) in engine.TRAINED.items():
            net, old = engine.nets[key], engine.optimizers[key]
            params = list(net.named_parameters())
            self.dims[key] = [leaf_spec(n, p.shape, grid.fsdp) for n, p in params]
            self.shards[key] = [torch.nn.Parameter(_shard(p, d, grid))
                                for (_, p), d in zip(params, self.dims[key])]
            self.ema[key] = [_shard(p, d, grid) for p, d in
                             zip(engine.nets[ema_key].parameters(), self.dims[key])]
            group = old.param_groups[0]
            opt = make_adam(self.shards[key], group["lr"], *group["betas"],
                            group["weight_decay"])
            for (_, p), s, d in zip(params, self.shards[key], self.dims[key]):
                if p in old.state:
                    opt.state[s] = {k: v if k == "step" else _shard(v, d, grid)
                                    for k, v in old.state[p].items()}
            engine.optimizers[key] = opt
        self.release_()

    def _nets(self, ema: bool):
        for key, (_, ema_key) in self.engine.TRAINED.items():
            yield key, self.engine.nets[ema_key if ema else key]

    def gather_(self, ema: bool = False) -> None:
        """The trained nets' parameters (with ``ema`` the EMA nets') whole
        from every rank's shards."""
        with torch.no_grad():
            for key, net in self._nets(ema):
                shards = [s.detach() for s in (self.ema[key] if ema else self.shards[key])]
                for p, whole in zip(net.parameters(),
                                    _gather_all(shards, self.dims[key], self.grid)):
                    p.data = whole

    def release_(self) -> None:
        """Free the whole parameters (and gradients) of the trained and the
        EMA nets; the shards stay."""
        for ema in (False, True):
            for _, net in self._nets(ema):
                for p in net.parameters():
                    p.data = p.data.new_empty(0)
                    p.grad = None

    def reduce_gradients_(self) -> None:
        """After a backward on the whole parameters: each gradient averaged
        over dp, then this rank's shard of its mean over fsdp, into its
        shard's ``.grad`` (a parameter the loss did not reach gets zeros)."""
        grid = self.grid
        for key, net in self._nets(False):
            params = list(net.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            all_reduce_mean_(grads, group=grid.dp_group)
            if grid.backend == "nccl":
                for g, s, d in zip(grads, self.shards[key], self.dims[key]):
                    if d is None:
                        dist.all_reduce(g, group=grid.fsdp_group)
                        s.grad = g.div_(grid.fsdp)
                        continue
                    full = g.movedim(d, 0).contiguous()
                    out = full.new_empty(full.shape[0] // grid.fsdp, *full.shape[1:])
                    dist.reduce_scatter_tensor(out, full, group=grid.fsdp_group)
                    s.grad = out.div_(grid.fsdp).movedim(0, d).contiguous()
            else:
                all_reduce_mean_(grads, group=grid.fsdp_group)
                for g, s, d in zip(grads, self.shards[key], self.dims[key]):
                    s.grad = _shard(g, d, grid)
            for p in params:
                p.grad = None

    def ema_step_(self, step: int) -> None:
        """The EMA shadows' shards after the optimizers stepped the
        parameters' (``optim.ema_update_tensors`` at ``step``)."""
        from ..models.optim import ema_update_tensors

        for key in self.shards:
            ema_update_tensors(self.ema[key], [s.detach() for s in self.shards[key]], step)

    def adam_view(self, key: str):
        """An optimizer-shaped view of net ``key``'s Adam with its moments
        gathered whole and keyed by the (gathered) net's parameters, for
        ``utils/convert.adam_state``."""
        opt = self.engine.optimizers[key]
        params = list(self.engine.nets[key].parameters())
        have = [i for i, s in enumerate(self.shards[key]) if s in opt.state]
        state = {params[i]: {"step": opt.state[self.shards[key][i]]["step"]} for i in have}
        for k in ("exp_avg", "exp_avg_sq"):
            wholes = _gather_all([opt.state[self.shards[key][i]][k] for i in have],
                                 [self.dims[key][i] for i in have], self.grid)
            for i, whole in zip(have, wholes):
                state[params[i]][k] = whole
        return types.SimpleNamespace(state=state, param_groups=opt.param_groups)

    def held_bytes(self) -> Dict[str, int]:
        """Bytes of the train state this rank keeps between steps (the
        parameters' shards, the moments' and the EMA shadows'), and what an
        unsharded rank keeps of the same."""
        held = full = 0
        for key, opt in self.engine.optimizers.items():
            for s, e, d in zip(self.shards[key], self.ema[key], self.dims[key]):
                ts = [s, e] + [v for k, v in opt.state.get(s, {}).items() if k != "step"]
                n = sum(t.numel() * t.element_size() for t in ts)
                held += n
                full += n * (self.grid.fsdp if d is not None else 1)
        return {"held": held, "unsharded": full}


__all__ = ["FSDP_REPLICATE_PATTERNS", "FSDPState", "Grid", "fsdp_spec", "gather_params",
           "leaf_spec", "shard_params_fsdp"]
