"""Host input pipeline: batching (port of ``instancediff_tpu/data/loader.py``).

Batches are dicts of stacked arrays: ``input``/``target`` [B,H,W,1],
``A_emb`` [B,1,E], ``type_idx`` [B] int32, and the records' names and paths.
A dataset with ``batch_load`` (the native reader) serves whole batches;
otherwise ``collate`` stacks ``dataset[i]``. The records come in the
sampler's order (the train loader's ``DistIterSampler``, set per epoch) or
in dataset order; with ``drop_last`` a short last batch is dropped. The JAX
loader's prefetch thread is left out: it changes no batch.
"""

from __future__ import annotations

import numpy as np


def collate(samples):
    return {
        "input": np.stack([s["LQ"] for s in samples]),
        "target": np.stack([s["GT"] for s in samples]),
        "A_emb": np.stack([s["A_emb"] for s in samples]),
        "type_idx": np.stack([s["type_idx"] for s in samples]),
        "names": [s["name"] for s in samples],
        "LQ_path": [s["LQ_path"] for s in samples],
        "GT_path": [s["GT_path"] for s in samples],
    }


class DataLoader:
    """``batch_size`` records a batch, in ``sampler``'s order or the
    dataset's."""

    def __init__(self, dataset, batch_size=1, sampler=None, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch):
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        idx = list(self.sampler) if self.sampler is not None else list(range(len(self.dataset)))
        fast = getattr(self.dataset, "batch_load", None)
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            yield fast(chunk) if fast is not None else collate([self.dataset[i] for i in chunk])
