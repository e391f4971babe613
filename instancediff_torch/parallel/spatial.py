"""Spatial parallelism: an image's height split over processes (port of
``instancediff_tpu/parallel/spatial.py``).

The JAX package shards dim 1 (H) of the [B, H, W, C] activations over a
mesh axis ``"sp"`` and lets XLA's SPMD partitioner insert the conv halo
exchanges and the GroupNorm and attention reductions. Here the axis is a
process group, one process per card (NCCL), or gloo for the CPU and for
ranks that share a card, and the collectives are written out where the
layers need them:

- a 3x3 conv takes each neighbour's nearest row(s) (``halo``), zero rows at
  the image's edges, where SAME pads with zeros (``layers.conv_same``,
  ``conv3x3``, ``conv_transpose_same``, ``fused_gn_conv.
  fused_gn_silu_conv3x3_sharded``);
- GroupNorm sums each shard's per-channel statistics over the ranks
  (``all_reduce_sum_``, ``ops/group_norm_silu.gn_affine_sharded``);
- the bottleneck attention runs its local queries against keys and values
  gathered in rank order (``gather_h``), as the score map module's decoder
  reads its gathered memory.

Gloo moves CPU tensors only for every collective but all-reduce and
broadcast, so a gather of CUDA tensors under gloo is staged through host
memory. Every collective has the group's timeout (``parallel.TIMEOUT`` when
``init_distributed`` made it).

An image is split only where every level of the UNet splits evenly
(``check_height``): it is refused, never padded.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


class SpatialGroup:
    """The ranks an image's rows are split over (JAX's ``"sp"`` axis): the
    process ``group`` (default: the whole world), this process's ``rank``
    in it and its size ``world``. Rank r holds rows [r * H/world, (r + 1) *
    H/world) of every image."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.staged = dist.get_backend(group) == "gloo"

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of x (dim 1); raises when they do not split evenly."""
        H = x.shape[1]
        if H % self.world:
            raise ValueError(f"{H} rows do not split over {self.world} ranks")
        h = H // self.world
        return x[:, self.rank * h:(self.rank + 1) * h]

    def gather_h(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 1 in rank order (the whole
        image from each rank's rows); every rank must call it with the same
        shape."""
        x = x.contiguous()
        src = x.cpu() if self.staged and x.device.type != "cpu" else x
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=1).to(x.device)

    def halo(self, x: torch.Tensor, top: int = 1, bottom: int = 1) -> tuple:
        """(the ``top`` rows above this rank's x, the ``bottom`` rows below
        it): the neighbours' nearest rows, zeros past the image's edges.
        One all-gather of each rank's first ``bottom`` and last ``top``
        rows."""
        H = x.shape[1]
        if top > H or bottom > H:
            raise ValueError(f"a halo of ({top}, {bottom}) rows around {H} rows")
        edges = self.gather_h(torch.cat([x[:, :bottom], x[:, H - top:]], dim=1))
        n = top + bottom

        def rows_of(r, start, count):
            if 0 <= r < self.world:
                return edges[:, r * n + start:r * n + start + count]
            return x.new_zeros(x.shape[0], count, *x.shape[2:])

        return rows_of(self.rank - 1, bottom, top), rows_of(self.rank + 1, 0, bottom)

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t


def shard_spatial(batch: dict, sp: SpatialGroup) -> dict:
    """This rank's part of a batch: the rows (dim 1) of every 4-D entry,
    every other entry whole (JAX's ``shard_spatial`` places 4-D entries with
    H on ``"sp"`` and replicates the rest)."""
    return {k: sp.rows(v) if getattr(v, "ndim", 0) == 4 else v for k, v in batch.items()}


def check_height(H: int, W: int, world: int, levels: int, pooled_levels: Sequence[int] = (),
                 max_mem_hw: int = 16) -> None:
    """Refuse an image height the UNet cannot split over ``world`` ranks:
    every level's rows must split evenly and stay even for the stride-2
    down convs, so H must divide by world x 2^(levels - 1); and each level
    in ``pooled_levels`` (the score map modules', whose memory average-pools
    the level to at most ``max_mem_hw`` rows and columns) must hold whole
    pooling windows on every rank."""
    unit = world * 2 ** (levels - 1)
    if H % unit:
        raise ValueError(f"spatial sharding: image height {H} does not split over {world} "
                         f"ranks at {levels} levels; the height must divide by world x "
                         f"2^(levels-1) = {unit}")
    for level in pooled_levels:
        h, w = H >> level, W >> level
        if h <= max_mem_hw and w <= max_mem_hw:
            continue
        window = max(h // max_mem_hw, 1)
        if (h // world) % window:
            raise ValueError(f"spatial sharding: level {level}'s score map memory pools "
                             f"{window} rows per window, which would straddle the {world} "
                             f"shards of {h // world} rows; each shard's rows at every "
                             "pooled level must divide by its pooling window")


__all__ = ["SpatialGroup", "check_height", "shard_spatial"]
