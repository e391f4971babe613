"""SpeckleMed dataset: a JSON index of paired raw-float32 medical images
(port of ``instancediff_tpu/data/med_dataset.py``).

- index schema ``{train|val|test: [{A, B, emb_A, name}, ...]}``, filtered by
  ``use_artifact_type`` and cut to ``max_dataset_size``;
- raw float32 files reshaped to (res, res, 1) (NHWC);
- per-modality normalisation: the CT clamp [0,1800]/1800 keyed only on the
  reference's literal ``'scatter artifact in CT'`` name, the cryo-EM clamp
  [0,255]/255, then the affine map to [-1, 1];
- the precomputed CLIP image embedding ``A_emb`` (zeros when absent);
- prompt names mapped to integer ``type_idx`` through ``type_map_ind``.

``batch_load`` reads a batch through the native reader (``native_io``);
``__getitem__`` with ``loader.collate`` is its plain NumPy version.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import native_io

DEFAULT_TYPE_MAP = {
    "speckle in OCT": 0,
    "speckle in ultra sound": 1,
    "noise in cryo-EM image": 2,
    "noise in low dose CT": 3,
    "Gaussian noise in MRI": 4,
}

_CT_NAMES = ("scatter artifact in CT",)
_CRYO_NAMES = ("noise in cryo-EM image",)


def normalize_pair(a_img, b_img, name):
    """Per-modality clamp/scale + affine to [-1,1] (MedSpeckle.py:55-70)."""
    if name in _CT_NAMES:
        a_img = np.clip(a_img, 0.0, 1800.0) / 1800.0
        b_img = np.clip(b_img, 0.0, 1800.0) / 1800.0
    elif name in _CRYO_NAMES:
        a_img = np.clip(a_img, 0.0, 255.0) / 255.0
        b_img = np.clip(b_img, 0.0, 255.0) / 255.0
    return a_img * 2.0 - 1.0, b_img * 2.0 - 1.0


class SpeckleMedDataset:
    """``gt_only``: the records carry clean images only (no ``A`` files); the
    input is a copy of the target, a placeholder that an engine with
    ``degrade_on_device`` replaces on the device. An index whose records all
    lack ``A`` is clean-only by itself; one that mixes both raises."""

    def __init__(self, data_flist, phase="train", max_dataset_size=1_000_000,
                 use_artifact_type=(), resolution=224, type_map_ind=None, emb_dim=512,
                 gt_only=False):
        self.resolution = resolution
        self.emb_dim = emb_dim
        self.type_map_ind = dict(type_map_ind or DEFAULT_TYPE_MAP)
        self.gt_only = bool(gt_only)
        with open(data_flist) as f:
            records = json.load(f)[phase]
        if use_artifact_type:
            records = [r for r in records if r["name"] in use_artifact_type]
        self.df = records[: int(max_dataset_size)]
        missing = next((r for r in self.df if "A" not in r), None)
        if not self.gt_only and missing is not None:
            if all("A" not in r for r in self.df):
                self.gt_only = True
            else:
                raise ValueError(
                    f"dataset index mixes records with and without 'A' (degraded) files "
                    f"(e.g. {missing.get('B', missing)}); use datasets.*.gt_only for a "
                    "clean-only split or fix the index")

    def __len__(self):
        return len(self.df)

    def batch_load(self, indices):
        """One parallel read of the batch's A/B/emb files with the
        normalisation fused in C++ (``native_io``); equal to
        ``loader.collate([self[i] for i in indices])``."""
        items = [self.df[i] for i in indices]
        res = self.resolution
        per_img = res * res
        names = [it["name"] for it in items]
        modes = [native_io.mode_for(n) for n in names]
        b = native_io.read_batch([it["B"] for it in items], per_img, modes)
        a = b.copy() if self.gt_only else native_io.read_batch([it["A"] for it in items],
                                                                per_img, modes)
        embs = []
        raw = native_io.MODES["raw"]
        emb_paths = [it.get("A_emb") or it.get("emb_A") for it in items]
        if all(emb_paths):
            sizes = {os.path.getsize(p) // 4 for p in emb_paths}
            if len(sizes) == 1:
                dim = sizes.pop()
                embs = native_io.read_batch(emb_paths, dim, [raw] * len(items))
                embs = embs.reshape(len(items), 1, dim)
        if len(embs) == 0:
            embs = np.zeros((len(items), 1, self.emb_dim), dtype=np.float32)
        return {
            "input": a.reshape(-1, res, res, 1),
            "target": b.reshape(-1, res, res, 1),
            "A_emb": np.asarray(embs, dtype=np.float32),
            "type_idx": np.asarray(
                [self.type_map_ind.get(n, 0) for n in names], dtype=np.int32),
            "names": names,
            "LQ_path": [it.get("A", it["B"]) for it in items],
            "GT_path": [it["B"] for it in items],
        }

    def __getitem__(self, index):
        item = self.df[index]
        res = self.resolution
        b_img = np.fromfile(item["B"], dtype=np.float32).reshape(res, res, 1)
        a_img = b_img.copy() if self.gt_only else np.fromfile(
            item["A"], dtype=np.float32).reshape(res, res, 1)
        if item.get("A_emb") or item.get("emb_A"):
            emb_path = item.get("A_emb") or item.get("emb_A")
            a_emb = np.fromfile(emb_path, dtype=np.float32).reshape(1, -1)
        else:
            a_emb = np.zeros((1, self.emb_dim), dtype=np.float32)
        name = item["name"]
        a_img, b_img = normalize_pair(a_img, b_img, name)
        return {
            "LQ": a_img.astype(np.float32),
            "GT": b_img.astype(np.float32),
            "LQ_path": item.get("A", item["B"]),
            "GT_path": item["B"],
            "name": name,
            "A_emb": a_emb,
            "type_idx": np.int32(self.type_map_ind.get(name, 0)),
        }


def create_SpeckleMedDataset(params):
    """Factory with reference semantics (MedSpeckle.py:76-89): phase from
    ``name.split('_')[0]``."""
    return SpeckleMedDataset(
        params["dataset_file"],
        phase=params["name"].split("_")[0],
        max_dataset_size=params.get("max_dataset_size") or 1_000_000,
        use_artifact_type=params.get("use_artifact_type") or (),
        resolution=params.get("resolution") or 224,
        type_map_ind=params.get("type_map_ind"),
        emb_dim=params.get("emb_dim") or 512,
        gt_only=bool(params.get("gt_only")),
    )
