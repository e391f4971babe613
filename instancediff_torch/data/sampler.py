"""Epoch-seeded distributed iteration sampler (port of
``instancediff_tpu/data/sampler.py``; numpy, so the permutation is JAX's)."""

from __future__ import annotations

import math

import numpy as np


class DistIterSampler:
    """One rank's indices of one epoch: the dataset enlarged by ``ratio``
    to ``num_samples`` per rank, a permutation of ``total_size`` seeded with
    the epoch, taken modulo the dataset and strided by rank, so the ranks
    share one permutation and split it. One replica at ratio 1 is the
    dataset's permutation."""

    def __init__(self, dataset_size, num_replicas=1, rank=0, ratio=1):
        if rank >= num_replicas:
            raise ValueError("rank must be < num_replicas")
        self.dataset_size = int(dataset_size)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.epoch = 0
        self.num_samples = int(math.ceil(self.dataset_size * ratio / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self):
        indices = np.random.default_rng(self.epoch).permutation(self.total_size)
        indices = (indices % self.dataset_size)[self.rank:self.total_size:self.num_replicas]
        return iter(indices.tolist())

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
