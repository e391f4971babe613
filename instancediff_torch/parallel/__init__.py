"""Data parallelism over processes: one process per card, the launch model
of the reference's PyTorch DDP (``python -m torch.distributed.run``), the
counterpart of the JAX package's data axis (``instancediff_tpu/parallel``:
a ``('dp',)`` mesh, the batch sharded along it, the gradient all-reduced by
XLA inside the jitted step).

Each process joins the group the launcher describes (``init_distributed``),
loads its own slice of every global batch (``shard_batch``; the train
loader does it with ``DistIterSampler``), computes its gradient on it and
averages the gradients over the ranks (``all_reduce_mean_``) before the
optimizer step, so every rank takes the step of the global batch's mean
loss and the ranks' parameters stay equal. Without a process group, or in a
world of one, every helper here does nothing. Nothing of
``make_mesh``/``NamedSharding`` is needed beyond this: the data axis is the
process group itself.

The JAX package's two other axes are the modules beside this one:
``mesh.py`` (ZeRO-style FSDP over a dp x fsdp grid of groups) and
``spatial.py`` (an image's height split over ranks, ``"sp"``)."""

from __future__ import annotations

import datetime
import os
import socket
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

# the most bytes one collective carries, flattened (the reference DDP's bucket size)
BUCKET_BYTES = 25 * 2**20
TIMEOUT = datetime.timedelta(minutes=10)


def free_port() -> int:
    """A TCP port on localhost that is free now (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     local_rank: Optional[int] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group that the launcher describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``: what ``torch.distributed.run`` sets); without
    ``WORLD_SIZE`` a world of one on a free localhost port. ``device``
    "cuda" is the card ``cuda:LOCAL_RANK`` (``local_rank`` overrides the
    environment's), made the current device, and NCCL; "cpu" is gloo; an
    explicit "cuda:N" takes that card. ``backend`` overrides the choice.
    Returns this process's device."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1, timeout=timeout)
    return dev


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_rank0() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shard_batch(batch: dict, part: Optional[int] = None, parts: Optional[int] = None) -> dict:
    """Part ``part`` of ``parts`` of a global batch: the contiguous slice
    along dim 0 of every array, tensor or list in ``batch``, as JAX's
    ``shard_batch`` lays the batch over the data axis; by default this
    process's rank of the world's size."""
    part = rank() if part is None else part
    parts = world_size() if parts is None else parts
    out = {}
    for k, v in batch.items():
        if len(v) % parts:
            raise ValueError(f"batch entry {k!r} of {len(v)} does not split into {parts}")
        b = len(v) // parts
        out[k] = v[part * b:(part + 1) * b]
    return out


def _buckets(tensors: List[torch.Tensor], bucket_bytes: int) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of ``tensors`` of one dtype and device, each at
    most ``bucket_bytes`` unless one tensor alone is larger."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > bucket_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _bucketed_(tensors, collective) -> int:
    """Run ``collective(flat)`` on each bucket of ``BUCKET_BYTES`` flattened
    into one tensor and copy the result back in place; returns the bytes it
    carried."""
    total = 0
    for run in _buckets(list(tensors), BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        for t, part in zip(run, torch.split(flat, [t.numel() for t in run])):
            t.copy_(part.view_as(t))
        total += flat.numel() * flat.element_size()
    return total


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None) -> int:
    """Average ``tensors`` in place over the ranks (of ``group``, default
    the world): flattened into buckets, one all-reduce (sum) per bucket,
    divided by the ranks' count. Every rank must pass the same list, in the
    same order. Returns the bytes reduced (0 without a group or in a group of
    one, where nothing happens)."""
    world = world_size() if group is None else dist.get_world_size(group)
    if world == 1:
        return 0

    def mean_(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    return _bucketed_(tensors, mean_)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> int:
    """Rank ``src``'s parameters and buffers into every rank's ``module``
    (ranks built from one seed start equal already; this guards a rank that
    loaded or resumed otherwise). Returns the bytes sent."""
    if world_size() == 1:
        return 0
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    return _bucketed_(tensors, lambda flat: dist.broadcast(flat, src))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (every rank must call it); the
    flag itself in a world of one."""
    if world_size() == 1:
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


__all__ = ["BUCKET_BYTES", "all_reduce_mean_", "any_rank", "barrier", "broadcast_module_",
           "free_port", "init_distributed", "is_rank0", "rank", "shard_batch", "shutdown",
           "world_size"]
