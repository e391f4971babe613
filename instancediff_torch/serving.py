"""Serving API: load once, restore many (port of ``Restorer`` in
``instancediff_tpu/serving.py``).

A ``Restorer`` holds an engine and a fixed batch size; ragged requests are
padded to that batch (edge mode) and chunked, so every sampler call sees one
shape: on CUDA every chunk replays the engine's one captured sampler step
(``SamplingEngine.test``), with no new capture in steady state. Noise comes
from one seeded ``torch.Generator`` on the device, which advances from chunk
to chunk.

Usage:
    r = Restorer.from_config("Configurations/flagship_test.yml",
                             pth_dir="experiments/flagship_224/models")
    restored = r.restore(images, ["speckle in OCT", ...])   # [N,H,W,1] in [-1,1]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device


def engine_from_config(opt, device="cuda", pth_dir: Optional[str] = None, iteration="latest",
                       use_ema: bool = True):
    """The sampling engine of parsed options ``opt`` (``train.which_model``,
    ``train.which_sde``; the top-level ``type_map_ind`` when the model block
    has none), with the bundle ``iteration`` of ``pth_dir`` (none: the
    engine's initial weights) loaded through ``engine.load``.
    ``test.on_device_emb`` (the on-device image tower) is not ported and
    raises."""
    from .models import create_model
    from .sde import create_sde

    if (opt.get("test") or {}).get("on_device_emb"):
        raise NotImplementedError(
            "test.on_device_emb needs the CLIP image tower (models/clip_vit.py), not "
            "ported yet (ROADMAP queue 1 item 5); without it a use_image_context "
            "model would be served zero embeddings it never saw")
    train_opt = opt.get("train") or {}
    model_opt = opt["models"][train_opt.get("which_model") or "DriftNoise"]
    if opt.get("type_map_ind") and not model_opt.get("type_map_ind"):
        model_opt["type_map_ind"] = opt["type_map_ind"]
    sde = create_sde(opt["sdes"][train_opt.get("which_sde") or "driftSDE"])
    engine = create_model(None, model_opt, phase="test", sde=sde, device=device)
    if pth_dir:
        engine.load(pth_dir, iteration, use_ema=use_ema)
    return engine


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

    @classmethod
    def from_config(cls, opt_path: str, pth_dir: Optional[str] = None, iteration="latest",
                    use_ema: bool = True, batch_size: int = 8,
                    sample_steps: Optional[int] = None, device="cuda", seed: int = 0,
                    eta: Optional[float] = None, spatial: int = 0) -> "Restorer":
        """A Restorer for the model a YAML config names
        (``engine_from_config``), with the bundle ``iteration`` of ``pth_dir``
        (default ``test.pth_dir``). ``device`` takes the place of the JAX
        version's ``platform``. ``spatial > 1`` (H-sharding over several
        devices) is not ported and raises."""
        from .config import load_options

        if spatial and spatial > 1:
            raise NotImplementedError("spatial > 1 shards H over several devices; the "
                                      "port serves on one card")
        opt = load_options(opt_path)
        engine = engine_from_config(opt, device=device,
                                    pth_dir=pth_dir or (opt.get("test") or {}).get("pth_dir"),
                                    iteration=iteration, use_ema=use_ema)
        r = cls(engine, batch_size=batch_size, use_ema=use_ema, sample_steps=sample_steps,
                seed=seed, eta=eta, device=device)
        if opt.get("type_map_ind"):
            r.type_map = dict(opt["type_map_ind"])
        return r

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
