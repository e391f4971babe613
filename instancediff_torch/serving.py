"""Serving API: load once, restore many (port of ``Restorer.__init__`` and
``Restorer.restore`` in ``instancediff_tpu/serving.py``).

A ``Restorer`` holds an engine and a fixed batch size; ragged requests are
padded to that batch (edge mode) and chunked, so every sampler call sees one
shape: on CUDA every chunk replays the engine's one captured sampler step
(``SamplingEngine.test``), with no new capture in steady state. Noise comes
from one seeded ``torch.Generator`` on the device, which advances from chunk
to chunk.

Usage:
    r = Restorer(engine, batch_size=8, sample_steps=4, seed=0)
    restored = r.restore(images, ["speckle in OCT", ...])   # [N,H,W,1] in [-1,1]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device


class Restorer:
    def __init__(self, engine, batch_size: int = 8, use_ema: bool = True,
                 sample_steps: Optional[int] = None, seed: int = 0,
                 eta: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine lives on {engine.device}, Restorer asked for "
                             f"{self.device}")
        self.engine = engine
        self.batch_size = int(batch_size)
        self.use_ema = use_ema
        self.sample_steps = sample_steps
        self.eta = eta
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.type_map = engine.type_map

    def restore(self, images, artifact_types: Sequence[str],
                emb: Optional[np.ndarray] = None) -> np.ndarray:
        """Restore N images ([N,H,W,1] float32 in [-1,1]); padded and chunked
        to the batch size. ``artifact_types`` are prompt names, one per image
        or a single name for all."""
        images = np.asarray(images, dtype=np.float32)
        N = images.shape[0]
        if isinstance(artifact_types, str):
            artifact_types = [artifact_types] * N
        if len(artifact_types) != N:
            raise ValueError(
                f"got {len(artifact_types)} artifact types for {N} images "
                "(pass one name per image, or a single name for all)")
        unknown = sorted({t for t in artifact_types if t not in self.type_map})
        if unknown:
            # a typo'd name must not silently condition on artifact index 0
            raise KeyError(f"unknown artifact type(s) {unknown}; "
                           f"known: {sorted(self.type_map)}")
        type_idx = np.asarray([self.type_map[t] for t in artifact_types], dtype=np.int64)
        if emb is None:
            emb = np.zeros((N, 1, self.engine.context_dim), dtype=np.float32)

        out = np.empty_like(images)
        B = self.batch_size
        for s in range(0, N, B):
            n = min(s + B, N) - s
            pad = B - n
            batch = {
                "input": np.pad(images[s:s + n], ((0, pad), (0, 0), (0, 0), (0, 0)),
                                mode="edge"),
                "type_idx": np.pad(type_idx[s:s + n], (0, pad), mode="edge"),
                "A_emb": np.pad(np.asarray(emb[s:s + n], dtype=np.float32),
                                ((0, pad), (0, 0), (0, 0)), mode="edge"),
            }
            pred = self.engine.test(batch, self.generator, use_ema=self.use_ema,
                                    sample_steps=self.sample_steps, eta=self.eta)
            out[s:s + n] = pred[:n].float().cpu().numpy()
        return out
