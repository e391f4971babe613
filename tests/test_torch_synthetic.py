"""The PyTorch port's Synthetic data against the JAX package's on the CPU.

The port's generator takes JAX's per-image ``rng.integers(2**31 - 1)`` as
the seed of a numpy generator for the degradation's noises, so under one
seed the clean files, the embedding files and the index are JAX's bytes and
only the degraded files differ; their residuals keep JAX's strength per
artifact type. ``create_dataset`` serves the ``Synthetic`` mode, and
``tools/make_synth_dataset`` writes a set and its manifest, whose generator
line rebuilds the same bytes."""

import os

import numpy as np
import pytest
import torch

from instancediff_tpu.data import synthetic as jax_synthetic

from instancediff_torch import data
from instancediff_torch.data import synthetic
from instancediff_torch.ops.degradations import apply_degradation
from instancediff_torch.tools import eval_protocol, make_synth_dataset
from instancediff_torch.tools.eval_manifest import MANIFEST_NAME, verify_manifest

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401


def _files(root):
    return {f: open(os.path.join(root, f), "rb").read() for f in sorted(os.listdir(root))}


def _write_both(tmp_path, monkeypatch, **kw):
    """JAX's and the port's ``write_synthetic_index`` with the same
    arguments and the same relative root ("set"), each from its own
    directory; returns both trees' files by name."""
    out = {}
    for name, fn in (("jax", jax_synthetic.write_synthetic_index),
                     ("port", synthetic.write_synthetic_index)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        fn("set", **kw)
        out[name] = _files(tmp_path / name / "set")
    return out["jax"], out["port"]


@pytest.mark.parametrize("gt_only", [False, True])
def test_clean_embedding_and_index_bytes_equal_jax(tmp_path, monkeypatch, gt_only):
    """Every artifact type (cryo-EM on the 0..255 scale among them), three
    splits: the same file names; the clean, embedding and index files byte
    for byte; the degraded files of the same shape but other values."""
    want, got = _write_both(tmp_path, monkeypatch, n_train=6, n_val=1, n_test=3, res=32,
                            seed=3, emb_dim=16, gt_only=gt_only)
    assert sorted(got) == sorted(want)
    assert any(f.endswith("_A.raw") for f in want) != gt_only
    for f in want:
        if f.endswith("_A.raw"):
            assert len(got[f]) == len(want[f]) and got[f] != want[f], f
        else:
            assert got[f] == want[f], f


def test_residual_strength_per_type_matches_jax_at_224(tmp_path, monkeypatch):
    """The degraded files' residual std per artifact type (two images each
    at 224 px, the same clean images on both sides) within 10 % of JAX's."""
    want, got = _write_both(tmp_path, monkeypatch, n_train=10, n_val=0, n_test=0, res=224,
                            seed=0, emb_dim=8)
    names = synthetic.ARTIFACTS
    for k, name in enumerate(names):
        stds = {}
        for side, files in (("jax", want), ("port", got)):
            res = []
            for i in (k, k + 5):
                a, b = (np.frombuffer(files[f"train_{i}_{s}.raw"], np.float32) for s in "AB")
                res.append(np.std(a - b) / (255.0 if name == "noise in cryo-EM image" else 1.0))
            stds[side] = float(np.mean(res))
        assert abs(stds["port"] - stds["jax"]) <= 0.1 * stds["jax"], (name, stds)


def test_dataset_items_match_jax_but_for_the_degraded_images():
    want = jax_synthetic.SyntheticMedDataset(n=6, res=32, seed=2, emb_dim=16)
    got = data.create_dataset({"mode": "Synthetic", "max_dataset_size": 6, "resolution": 32,
                               "seed": 2})
    assert isinstance(got, synthetic.SyntheticMedDataset) and len(got) == 6
    port = synthetic.SyntheticMedDataset(n=6, res=32, seed=2, emb_dim=16)
    for i in range(6):
        w, g = want[i], port[i]
        np.testing.assert_array_equal(g["GT"], w["GT"])
        np.testing.assert_array_equal(g["A_emb"], w["A_emb"])
        assert g["LQ"].shape == w["LQ"].shape and g["LQ"].dtype == np.float32
        assert not np.array_equal(g["LQ"], w["LQ"])
        assert (g["name"], g["type_idx"], g["LQ_path"]) == (w["name"], w["type_idx"],
                                                             w["LQ_path"])


def test_degradation_is_apply_degradation_on_numpy_noise():
    """One degraded image: ``apply_degradation`` of the clean image with the
    five noises drawn in order from ``default_rng(seed)``, clipped to
    [0, 1]."""
    clean = synthetic.make_phantom(np.random.default_rng(0), 16)
    for name, idx in data.DEFAULT_TYPE_MAP.items():
        got = synthetic.degrade_with_seed(11, clean, name)
        rng = np.random.default_rng(11)
        noise = [torch.from_numpy(rng.standard_normal((1, 16, 16, 1)).astype(np.float32))
                 for _ in range(5)]
        x = torch.from_numpy(clean)[None, ..., None] * 2 - 1
        want = apply_degradation(x, torch.tensor([idx]), noise=noise)[0, ..., 0].numpy()
        np.testing.assert_array_equal(got, np.clip((want + 1) / 2, 0, 1).astype(np.float32))


def test_make_synth_dataset_pins_and_rebuilds_its_set(tmp_path, monkeypatch):
    """The tool writes the set and a manifest whose generator line is its
    own command; the set verifies, and after a file is deleted, running the
    generator line rebuilds the same bytes."""
    monkeypatch.chdir(tmp_path)
    make_synth_dataset.main(["--root", "synth", "--res", "16", "--n-train", "2", "--n-val",
                             "1", "--n-test", "2", "--emb-dim", "8", "--types",
                             "speckle in OCT", "noise in low dose CT"])
    ok, problems, generator = verify_manifest("synth")
    assert ok, problems
    assert generator == ("python -m instancediff_torch.tools.make_synth_dataset --root synth "
                         "--res 16 --n-train 2 --n-val 1 --n-test 2 --emb-dim 8 --seed 0 "
                         "--types 'speckle in OCT' 'noise in low dose CT'")
    before = _files("synth")
    os.remove(os.path.join("synth", "test_1_A.raw"))
    assert not verify_manifest("synth")[0]
    eval_protocol.regenerate(generator)
    assert _files("synth") == before and MANIFEST_NAME in before


@pytest.mark.parametrize("demo,n", [("demo_restoration", 4), ("demo_all_modalities", 5)])
def test_demos_run_on_the_cpu_when_asked(demo, n):
    """The demos end to end at 2 train steps (their widths, data and
    learning rates; 600 and 800 steps by default): per image or modality the
    degraded score of the data itself and a finite restored score."""
    import importlib

    from instancediff_torch.tools.demo_restoration import synthetic_arrays
    from instancediff_torch.utils.metrics import eval_restoration

    mod = importlib.import_module(f"instancediff_torch.tools.{demo}")
    scores = mod.main(["--device", "cpu", "--steps", "2"])
    rows = list(scores.values()) if isinstance(scores, dict) else scores
    assert len(rows) == n
    if isinstance(scores, dict):
        assert list(scores) == ["OCT-Sp", "US-Sp", "CryoEM-N", "LoDose-CT", "MRI-N"]
    data = synthetic_arrays(20 if n == 5 else 16, None if n == 5 else ["speckle in OCT"])
    for j, row in enumerate(rows):
        want = eval_restoration(data["input"][j, ..., 0], data["target"][j, ..., 0])
        assert row["degraded"]["PSNR"] == want["PSNR"]
        assert np.isfinite([row["restored"]["PSNR"], row["restored"]["SSIM"]]).all()
