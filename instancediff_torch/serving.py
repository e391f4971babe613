"""Serving API: load once, restore many (port of ``Restorer`` in
``instancediff_tpu/serving.py``).

A ``Restorer`` holds an engine and a fixed batch size; ragged requests are
padded to that batch (edge mode) and chunked, so every sampler call sees one
shape: on CUDA every chunk replays the engine's one captured sampler step
(``SamplingEngine.test``), with no new capture in steady state. Noise comes
from one seeded ``torch.Generator`` on the device, which advances from chunk
to chunk.

With ``spatial=N`` the Restorer serves inside a process group of N ranks,
one per card (``python -m torch.distributed.run --nproc_per_node N``, or a
group the caller joined already): each rank holds the engine on its own
device, every rank restores the same request, the images' height split over
the ranks (``parallel/spatial.py``), and ``restore`` returns the whole images
on every rank, as the JAX Restorer returns its sharded result gathered.

Usage:
    r = Restorer.from_config("Configurations/flagship_test.yml",
                             pth_dir="experiments/flagship_224/models")
    restored = r.restore(images, ["speckle in OCT", ...])   # [N,H,W,1] in [-1,1]
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device


# the image tower's weights beside a bundle, and the script that writes them
# with JAX
IMAGE_SIDECAR = "image_params.ckpt"
IMAGE_EXPORT_TOOL = "tools/export_image_params.py"


def engine_from_config(opt, device="cuda", pth_dir: Optional[str] = None, iteration="latest",
                       use_ema: bool = True):
    """The sampling engine of parsed options ``opt`` (``train.which_model``,
    ``train.which_sde``; the top-level ``type_map_ind`` when the model block
    has none), with the bundle ``iteration`` of ``pth_dir`` (none: the
    engine's initial weights) loaded through ``engine.load``. With
    ``test.on_device_emb`` an engine that takes an image tower (the drift
    engine) gets ``clip_vit.build_image_tower`` at ``resolution``, its
    weights read from ``image_params.ckpt`` beside the bundle
    (``tools/export_image_params.py`` writes them with JAX: the tower JAX's
    ``from_config`` draws from key 7); without that file it raises, since a
    tower the port drew itself is not the one JAX serves with."""
    from .models import create_model
    from .sde import create_sde

    train_opt = opt.get("train") or {}
    model_opt = opt["models"][train_opt.get("which_model") or "DriftNoise"]
    if opt.get("type_map_ind") and not model_opt.get("type_map_ind"):
        model_opt["type_map_ind"] = opt["type_map_ind"]
    engine = create_model(None, model_opt, phase="test", device=device)
    engine.set_sde(create_sde(opt["sdes"][train_opt.get("which_sde") or "driftSDE"]))
    if pth_dir:
        engine.load(pth_dir, iteration, use_ema=use_ema)
    if (opt.get("test") or {}).get("on_device_emb") and hasattr(engine, "attach_image_tower"):
        engine.attach_image_tower(load_image_tower(opt, model_opt, engine.context_dim, pth_dir))
    return engine


def load_image_tower(opt, model_opt, embed_dim: int, pth_dir: Optional[str]):
    """The image tower of ``opt`` (``build_image_tower`` at ``resolution``,
    tiny with ``tiny_text_encoder``) filled from ``<pth_dir>/image_params.ckpt``
    with the port's codec; raises, naming the export command, when the file
    is missing."""
    from .models.clip_vit import build_image_tower
    from .utils.checkpoint import load_pytree
    from .utils.convert import load_flax_params

    path = os.path.join(pth_dir or ".", IMAGE_SIDECAR)
    if not pth_dir or not os.path.isfile(path):
        raise FileNotFoundError(
            f"test.on_device_emb: {path} is missing. The port draws no image tower of its "
            "own (JAX draws it from key 7); write the sidecar with JAX: python "
            f"{IMAGE_EXPORT_TOOL} -opt <config> --models-dir {pth_dir or '<models dir>'}")
    tower = build_image_tower(embed_dim=embed_dim, tiny=bool(model_opt.get("tiny_text_encoder")),
                              image_size=opt.get("resolution") or 224)
    return load_flax_params(tower, load_pytree(path))


def spatial_group(spatial: int, device="cuda"):
    """The ``SpatialGroup`` of a ``spatial``-rank Restorer (None for 0 or
    1): the process group already joined, else the one the launcher's
    environment describes (``parallel.init_distributed``: ``cuda`` is this
    rank's card ``cuda:LOCAL_RANK`` over NCCL, ``cpu`` gloo), which must hold
    ``spatial`` ranks. Returns (group or None, this rank's device)."""
    from . import parallel
    from .parallel.spatial import SpatialGroup

    if not spatial or spatial <= 1:
        return None, device
    joined = parallel.world_size() > 1
    world = parallel.world_size() if joined else int(os.environ.get("WORLD_SIZE", 1))
    if world != spatial:
        raise ValueError(f"spatial={spatial} needs a process group of {spatial} ranks, "
                         f"this one has {world} (launch with python -m "
                         f"torch.distributed.run --nproc_per_node {spatial})")
    if not joined:
        device = parallel.init_distributed(str(device))
    return SpatialGroup(), device


class Restorer:
    def __init__(self, engine, batch_size: int = 8, use_ema: bool = True,
                 sample_steps: Optional[int] = None, seed: int = 0,
                 eta: Optional[float] = None, device="cuda", spatial: int = 0):
        """``spatial > 1`` shards the images' height over that many ranks
        (``spatial_group``; the engine must live on this rank's device); each
        rank's generator is seeded alike, so the ranks draw the same noise."""
        self.sp, device = spatial_group(spatial, device)
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
        version's ``platform``. ``spatial > 1`` joins (or uses) a process
        group of that many ranks and builds the engine on this rank's device
        (``spatial_group``), then shards each request's height over them."""
        from .config import load_options

        _, device = spatial_group(spatial, device)
        opt = load_options(opt_path)
        engine = engine_from_config(opt, device=device,
                                    pth_dir=pth_dir or (opt.get("test") or {}).get("pth_dir"),
                                    iteration=iteration, use_ema=use_ema)
        r = cls(engine, batch_size=batch_size, use_ema=use_ema, sample_steps=sample_steps,
                seed=seed, eta=eta, device=device, spatial=spatial)
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
                                    sample_steps=self.sample_steps, eta=self.eta,
                                    spatial=self.sp)
            out[s:s + n] = pred[:n].float().cpu().numpy()
        return out
