"""Host input pipeline: in-order batching (port of
``instancediff_tpu/data/loader.py``, the test and validation loaders).

Batches are dicts of stacked arrays: ``input``/``target`` [B,H,W,1],
``A_emb`` [B,1,E], ``type_idx`` [B] int32, and the records' names and paths.
A dataset with ``batch_load`` (the native reader) serves whole batches;
otherwise ``collate`` stacks ``dataset[i]``. The last batch may be short.
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
    """The dataset in order, ``batch_size`` records a batch."""

    def __init__(self, dataset, batch_size=1):
        self.dataset = dataset
        self.batch_size = int(batch_size)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        fast = getattr(self.dataset, "batch_load", None)
        for s in range(0, len(self.dataset), self.batch_size):
            chunk = list(range(s, min(s + self.batch_size, len(self.dataset))))
            yield fast(chunk) if fast is not None else collate([self.dataset[i] for i in chunk])
