"""Epoch-seeded iteration sampler (port of ``instancediff_tpu/data/sampler.py``
for one replica at ratio 1; numpy, so the permutation is JAX's)."""

from __future__ import annotations

import numpy as np


class DistIterSampler:
    """The indices of one epoch: a permutation of ``dataset_size`` seeded
    with the epoch. The port trains on one card; the replica and ``ratio``
    knobs come back with data parallelism (ROADMAP queue 1)."""

    def __init__(self, dataset_size):
        self.dataset_size = int(dataset_size)
        self.epoch = 0

    def __iter__(self):
        return iter(np.random.default_rng(self.epoch).permutation(self.dataset_size).tolist())

    def __len__(self):
        return self.dataset_size

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
