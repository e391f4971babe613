"""Synthetic SpeckleMed-compatible data (port of
``instancediff_tpu/data/synthetic.py``): in-memory datasets of phantoms, and
a raw-float32 file tree with its JSON index in the SpeckleMed schema, so the
file-based drivers run without the reference's unreleased assets.

Clean images are smooth random phantoms (Gaussian blobs on a sinusoid);
each is degraded per artifact type by ``ops/degradations.apply_degradation``.
The JAX generator takes one ``rng.integers(2**31 - 1)`` per degraded image
as a threefry key; this one takes the same draw as the seed of a numpy
``Generator`` and draws the five candidate noises from it. So the numpy
stream stays aligned with JAX's: under one seed the clean files, the
embedding files and the index are byte-identical to JAX's, and only the
degraded images differ (as the sampler's noise does). A dataset pinned by a
manifest written from JAX's generator is not rebuilt by this one."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.degradations import apply_degradation
from .med_dataset import DEFAULT_TYPE_MAP, normalize_pair

ARTIFACTS = list(DEFAULT_TYPE_MAP)


def make_phantom(rng, res=224):
    """Smooth structured phantom in [0,1]."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    img = 0.15 * np.sin(2 * np.pi * (3 * yy + rng.uniform(0, 1))) + 0.5
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        s = rng.uniform(0.03, 0.2)
        a = rng.uniform(-0.4, 0.5)
        img = img + a * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2)))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def degrade_with_seed(seed: int, clean01, name):
    """``name``'s degradation of a [0,1] image, its five candidate noises
    drawn from ``numpy.random.default_rng(seed)`` (standard normals, in
    candidate order) and applied by ``apply_degradation`` on the CPU in
    float32; output clipped to [0,1] (the files store clipped intensity)."""
    res = clean01.shape
    noise_rng = np.random.default_rng(int(seed))
    noise = [torch.from_numpy(noise_rng.standard_normal((1, *res, 1)).astype(np.float32))
             for _ in range(5)]
    x = torch.from_numpy(np.asarray(clean01, np.float32))[None, ..., None] * 2.0 - 1.0
    idx = torch.full((1,), DEFAULT_TYPE_MAP[name], dtype=torch.int64)
    y = apply_degradation(x, idx, noise=noise)
    out01 = (y[0, ..., 0].numpy() + 1.0) / 2.0
    return np.clip(out01, 0.0, 1.0).astype(np.float32)


def degrade(rng, clean01, name):
    """Degrade with a seed drawn from ``rng`` (the draw JAX's generator
    turns into a key)."""
    return degrade_with_seed(int(rng.integers(2**31 - 1)), clean01, name)


class SyntheticMedDataset:
    """In-memory dataset with the SpeckleMedDataset item contract."""

    def __init__(self, n=8, res=224, artifact_types=None, seed=0, emb_dim=512):
        self.res = res
        self.emb_dim = emb_dim
        types = list(artifact_types or ARTIFACTS)
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            name = types[i % len(types)]
            clean = make_phantom(rng, res)
            deg = degrade(rng, clean, name)
            # stored in the raw intensity domain and normalised as the file
            # path does (only the cryo-EM images are on the 0..255 scale)
            if name == "noise in cryo-EM image":
                clean_raw, deg_raw = clean * 255.0, deg * 255.0
            else:
                clean_raw, deg_raw = clean, deg
            emb = rng.standard_normal((1, emb_dim)).astype(np.float32) * 0.02
            self.items.append((deg_raw[..., None], clean_raw[..., None], name, emb, i))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        a_raw, b_raw, name, emb, i = self.items[index]
        a, b = normalize_pair(a_raw.copy(), b_raw.copy(), name)
        return {
            "LQ": a.astype(np.float32),
            "GT": b.astype(np.float32),
            "LQ_path": f"synthetic://A/{i}",
            "GT_path": f"synthetic://B/{i}",
            "name": name,
            "A_emb": emb,
            "type_idx": np.int32(DEFAULT_TYPE_MAP[name]),
        }


def make_synthetic_dataset(params):
    """The ``Synthetic`` mode of a ``datasets.*`` block. It also reads
    ``emb_dim`` (default 512, JAX's, which reads none), as the SpeckleMed
    mode does, so a net of another context width can train on it."""
    return SyntheticMedDataset(
        n=params.get("max_dataset_size") or 8,
        res=params.get("resolution") or 224,
        artifact_types=params.get("use_artifact_type"),
        seed=params.get("seed") or 0,
        emb_dim=params.get("emb_dim") or 512,
    )


def write_synthetic_index(root, n_train=8, n_val=2, n_test=2, res=224, artifact_types=None,
                          seed=0, emb_dim=512, gt_only=False):
    """Write raw-f32 files + ``dataset_file.json`` in the SpeckleMed schema
    under ``root``; returns the index's path. ``gt_only``: clean images only
    (no ``*_A.raw``), for the on-device degradation pipeline
    (``datasets.*.gt_only`` with ``degrade_on_device``)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    types = list(artifact_types or ARTIFACTS)
    index = {"train": [], "val": [], "test": []}
    counter = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        for i in range(n):
            name = types[counter % len(types)]
            clean = make_phantom(rng, res)
            deg = None if gt_only else degrade(rng, clean, name)
            if name == "noise in cryo-EM image":
                clean = clean * 255.0
                deg = None if deg is None else deg * 255.0
            b_path = os.path.join(root, f"{split}_{i}_B.raw")
            e_path = os.path.join(root, f"{split}_{i}_emb.raw")
            clean.astype(np.float32).tofile(b_path)
            (rng.standard_normal(emb_dim).astype(np.float32) * 0.02).tofile(e_path)
            rec = {"B": b_path, "A_emb": e_path, "name": name}
            if deg is not None:
                a_path = os.path.join(root, f"{split}_{i}_A.raw")
                deg.astype(np.float32).tofile(a_path)
                rec["A"] = a_path
            index[split].append(rec)
            counter += 1
    index_path = os.path.join(root, "dataset_file.json")
    with open(index_path, "w") as f:
        json.dump(index, f, indent=1)
    return index_path
