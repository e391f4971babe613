"""Serving and evaluation from a bundle, the PyTorch port against the JAX
package on the CPU: ``create_model``/``create_sde`` on
``Configurations/tiny_cpu.yml``, ``Restorer.from_config`` on a bundle JAX
saved, the SpeckleMed loader (native reader and its NumPy version), the
metrics, and the ``restore`` and ``testUM`` drivers end to end.

One JAX engine: ``create_model`` on ``tiny_cpu.yml`` (nf 8, ch_mult [1, 2],
the tiny text tower, 32 px, T=8), every leaf randomised from a numpy seed,
saved with its text tower's sidecar."""

import os

import numpy as np
import pytest

import jax
import torch
import yaml

from instancediff_tpu import data as jax_data
from instancediff_tpu.config import dict_to_nonedict, ordered_yaml
from instancediff_tpu.models import create_model as jax_create_model
from instancediff_tpu.sde import create_sde as jax_create_sde
from instancediff_tpu.utils import checkpoint as jax_ckpt
from instancediff_tpu.utils.metrics import eval_restoration as jax_eval_restoration

import chip_smoke
from instancediff_torch import data
from instancediff_torch.config import load_options
from instancediff_torch.data import native_io
from instancediff_torch.data.loader import collate
from instancediff_torch.models import create_model
from instancediff_torch.models.engine import TEXT_SIDECAR
from instancediff_torch.sde import create_sde
from instancediff_torch.serving import Restorer
from instancediff_torch.tools import restore, testUM
from instancediff_torch.utils.convert import flax_params
from instancediff_torch.utils.metrics import eval_restoration

from test_torch_bundle import _flat
from test_torch_engine import (_jax_noise, one_torch_thread, quick_jax_compiles,  # noqa: F401
                               shapes_only_init)

CONFIG = "Configurations/tiny_cpu.yml"
ITER, RES, EMB = 4, 32, 16
NETS = ("drift", "noise", "d_ema", "n_ema")
# names with each normalisation: CT clamp, cryo-EM clamp, plain affine
NAMES = ("scatter artifact in CT", "noise in cryo-EM image", "speckle in OCT",
         "Gaussian noise in MRI")


def _jax_options(path):
    loader, _ = ordered_yaml()
    with open(path) as f:
        return dict_to_nonedict(yaml.load(f, Loader=loader))


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def jax_engine():
    opt = _jax_options(CONFIG)
    with shapes_only_init():
        eng = jax_create_model(None, opt["models"]["DriftNoise"], phase="test", image_size=RES)
    eng.set_sde(jax_create_sde(opt["sdes"]["driftSDE"]))
    rng = np.random.default_rng(0)
    for key in NETS:
        eng.state[key] = chip_smoke.seeded_tree(eng.state[key], rng)
    eng.text_params = chip_smoke.seeded_tree(eng.text_params, rng)
    return eng


@pytest.fixture(scope="module")
def bundle(jax_engine, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("models"))
    jax_engine.save(d, ITER)
    jax_ckpt.save_pytree(jax_engine.text_params, os.path.join(d, TEXT_SIDECAR))
    return d


def _batch(seed=1, n=2):
    rng = np.random.default_rng(seed)
    return {"input": rng.uniform(-1, 1, (n, RES, RES, 1)).astype(np.float32),
            "type_idx": np.array([0, 4] * (n // 2), np.int32),
            "A_emb": rng.standard_normal((n, 1, EMB)).astype(np.float32)}


def test_create_model_on_tiny_cpu_builds_the_jax_nets(jax_engine):
    opt = load_options(CONFIG)
    eng = create_model(None, opt["models"]["DriftNoise"], phase="test",
                       sde=create_sde(opt["sdes"]["driftSDE"]), device="cpu")
    for k in NETS:
        assert _shapes(flax_params(eng.nets[k])) == _shapes(jax_engine.state[k])
    assert _shapes(flax_params(eng.text_encoder)) == _shapes(jax_engine.text_params)
    np.testing.assert_array_equal(eng.prompt_ids.numpy(), np.asarray(jax_engine.prompt_ids))
    assert eng.type_map == jax_engine.type_map
    assert (eng.sde.T, eng.sde.eta) == (jax_engine.sde.T, jax_engine.sde.eta) == (8, 1.0)
    for name in ("drift_schedule", "noise_schedule", "sigmas"):
        np.testing.assert_array_equal(getattr(eng.sde, name).numpy(),
                                      np.asarray(getattr(jax_engine.sde, name)))


def test_from_config_serves_a_jax_bundle(jax_engine, bundle):
    """``Restorer.from_config`` on the bundle JAX saved (and its sidecar):
    every net and the text tower hold JAX's weights (the sampler on them is
    held to JAX in ``test_torch_bundle.py``), the config's type map, and a
    ragged request through ``restore``."""
    r = Restorer.from_config(CONFIG, pth_dir=bundle, iteration=ITER, batch_size=2,
                             sample_steps=2, device="cpu")
    assert r.engine.device.type == "cpu" and r.engine.text_weights == "sidecar"
    assert r.type_map == {"speckle in OCT": 0, "Gaussian noise in MRI": 4}
    for k in NETS:
        got, want = _flat(flax_params(r.engine.nets[k])), _flat(jax_engine.state[k])
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])
    out = r.restore(_batch(2, 4)["input"][:3], ["speckle in OCT", "Gaussian noise in MRI",
                                                "speckle in OCT"])
    assert out.shape == (3, RES, RES, 1) and np.isfinite(out).all()


def test_from_config_refuses_what_is_not_ported(bundle, tmp_path, monkeypatch):
    # spatial sharding runs in a group of that many ranks (tests/test_torch_spatial.py)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        Restorer.from_config(CONFIG, pth_dir=bundle, iteration=ITER, device="cpu", spatial=2)
    opt = yaml.safe_load(open(CONFIG))
    opt["test"]["on_device_emb"] = True
    path = tmp_path / "emb.yml"
    path.write_text(yaml.safe_dump(opt))
    # the on-device image tower needs its weights beside the bundle
    with pytest.raises(FileNotFoundError, match="export_image_params.py"):
        Restorer.from_config(str(path), pth_dir=bundle, iteration=ITER, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Restorer.from_config(CONFIG, pth_dir=bundle, iteration=ITER)


def _dataset_opt(index, batch_size):
    return {"name": "test_dataset", "mode": "SpeckleMed", "phase": "test",
            "batch_size": batch_size, "resolution": RES, "emb_dim": EMB,
            "dataset_file": index, "use_artifact_type": list(NAMES)}


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


def test_speckle_med_batches_equal_jax(tmp_path):
    """The port's loader (the native reader) and its plain version
    (``__getitem__`` + ``collate``) give JAX's loader batches bit for bit,
    ragged last batch included."""
    index = chip_smoke.write_speckle_med(str(tmp_path), 2, RES, EMB, NAMES)
    opt = _dataset_opt(index, 3)
    port_ds = data.create_dataset(dict(opt))
    want = list(jax_data.create_dataloader(jax_data.create_dataset(dict(opt)), dict(opt)))
    got = list(data.create_dataloader(port_ds, dict(opt)))
    assert len(got) == len(want) == 3
    for g, w, start in zip(got, want, (0, 3, 6)):
        _assert_batches_equal(g, w)
        idx = range(start, min(start + 3, len(port_ds)))
        _assert_batches_equal(collate([port_ds[i] for i in idx]), w)
    assert sorted(set(got[0]["names"] + got[1]["names"])) == sorted(NAMES)


def test_native_reader_raises_instead_of_falling_back(tmp_path, monkeypatch):
    good = tmp_path / "x.raw"
    np.arange(16, dtype=np.float32).tofile(good)
    np.testing.assert_array_equal(native_io.read_batch([str(good)], 16, [native_io.MODES["raw"]]),
                                  np.arange(16, dtype=np.float32)[None])
    with pytest.raises(OSError, match="rc=-1"):
        native_io.read_batch([str(tmp_path / "missing.raw")], 16, [0])
    with pytest.raises(OSError, match="rc=-2"):
        native_io.read_batch([str(good)], 32, [0])
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native_io.read_batch([str(good)], 16, [0])


def test_native_io_available_as_in_jax(tmp_path, monkeypatch):
    """``available()`` reports what JAX's reports on this machine; a library
    that does not build makes it False and leaves ``read_batch`` raising."""
    from instancediff_tpu.data import native_io as jax_native_io

    assert native_io.available() == jax_native_io.available()
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setenv("CXX", "false")
    assert native_io.available() is False
    with pytest.raises(RuntimeError, match="failed"):
        native_io.read_batch([str(tmp_path / "x.raw")], 16, [0])


def test_eval_restoration_equals_jax():
    rng = np.random.default_rng(5)
    target = rng.uniform(-1, 1, (48, 40)).astype(np.float32)
    for pred in (target + 0.1 * rng.standard_normal(target.shape).astype(np.float32),
                 np.clip(target * 0.8, -1, 1)):
        got, want = eval_restoration(pred, target), jax_eval_restoration(pred, target)
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6


def test_restore_cli_end_to_end(bundle, tmp_path):
    rng = np.random.default_rng(6)
    raw, npy = str(tmp_path / "scan0.raw"), str(tmp_path / "scan1.npy")
    rng.uniform(0, 1, RES * RES).astype(np.float32).tofile(raw)
    np.save(npy, rng.uniform(0, 1, (RES, RES)).astype(np.float32))
    out = str(tmp_path / "out")
    paths = restore.main(["-opt", CONFIG, "--images", raw, npy, "--type", "speckle in OCT",
                          "--pth-dir", bundle, "--iter", str(ITER), "--out", out,
                          "--sample-steps", "2", "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["scan0_restored.raw", "scan1_restored.raw"]
    for p in paths:
        img = np.fromfile(p, dtype=np.float32)
        assert img.size == RES * RES and np.isfinite(img).all()
        assert os.path.isfile(p[:-4] + ".png")
    with pytest.raises(SystemExit, match="unknown --type"):
        restore.main(["-opt", CONFIG, "--images", raw, "--type", "noise in cryo-EM image",
                      "--pth-dir", bundle, "--iter", str(ITER), "--out", out,
                      "--device", "cpu"])


def test_testUM_end_to_end(bundle, tmp_path):
    """``testUM`` on a SpeckleMed dataset of 8 images in two modalities,
    batch 3: per-modality RMSE/SSIM/PSNR and one LQ|pred|GT triptych per
    image."""
    names = ("speckle in OCT", "Gaussian noise in MRI")
    index = chip_smoke.write_speckle_med(str(tmp_path / "data"), 4, RES, EMB, names)
    opt = yaml.safe_load(open(CONFIG))
    opt["datasets"] = {"test": dict(_dataset_opt(index, 1), use_artifact_type=list(names))}
    opt["test"].update(pth_dir=bundle, iter=ITER, batch_size=3,
                       result_dir=str(tmp_path / "results"))
    cfg = tmp_path / "test.yml"
    cfg.write_text(yaml.safe_dump(opt))
    results = testUM.main(["-opt", str(cfg), "--device", "cpu", "--sample-steps", "2"])
    assert sorted(results) == sorted(names)
    for name in names:
        assert results[name]["num"] == 4
        for k in ("RMSE", "SSIM", "PSNR"):
            assert len(results[name][k]) == 4 and np.isfinite(results[name][k]).all()
        files = os.listdir(tmp_path / "results" / name)
        assert len(files) == 4 and all(f.endswith(f"_{3 * RES}x{RES}x1.raw") for f in files)
        trip = np.fromfile(tmp_path / "results" / name / files[0], dtype=np.float32)
        assert trip.size == 3 * RES * RES


def test_testUM_knob_selects_the_engine_body(bundle, tmp_path, monkeypatch):
    """``--knob name=value`` overrides the ``engine`` block as ``testUM.py``
    does: ``fused_gnconv=0`` builds every net on the unfused ResBlock body,
    whose metrics equal the fused run's within float32 summation order (the
    two bodies' rule in ``test_torch_engine.py``: 1e-5); an unknown knob
    raises ``KeyError`` when the engine is built, before any batch. (The
    file runs no JAX testUM, so the fused run is the reference.)"""
    names = ("speckle in OCT", "Gaussian noise in MRI")
    index = chip_smoke.write_speckle_med(str(tmp_path / "data"), 2, RES, EMB, names)
    opt = yaml.safe_load(open(CONFIG))
    opt["datasets"] = {"test": dict(_dataset_opt(index, 1), use_artifact_type=list(names))}
    opt["test"].update(pth_dir=bundle, iter=ITER, batch_size=2,
                       result_dir=str(tmp_path / "results"))
    cfg = tmp_path / "test.yml"
    cfg.write_text(yaml.safe_dump(opt))
    argv = ["-opt", str(cfg), "--device", "cpu", "--sample-steps", "2"]
    engines = []
    real = testUM.engine_from_config
    monkeypatch.setattr(testUM, "engine_from_config",
                        lambda *a, **kw: engines.append(real(*a, **kw)) or engines[-1])
    fused = testUM.main(argv)
    unfused = testUM.main(argv + ["--knob", "fused_gnconv=0", "--knob", "flash_mid=-1"])
    assert engines[0].engine_opts == {}
    assert engines[1].engine_opts == {"fused_gnconv": 0, "flash_mid": -1}
    assert all(net.use_fused_gnconv for net in engines[0].nets.values())
    assert not any(net.use_fused_gnconv for net in engines[1].nets.values())
    assert sorted(unfused) == sorted(fused) == sorted(names)
    for name in names:
        assert unfused[name]["num"] == fused[name]["num"] == 2
        for k in ("RMSE", "SSIM", "PSNR"):
            np.testing.assert_allclose(unfused[name][k], fused[name][k], rtol=1e-5, atol=1e-5)
    assert testUM.parse_knobs(["a=1", "b=-2", "c=x", "d=1.5", "e="]) == {
        "a": 1, "b": -2, "c": "x", "d": "1.5", "e": ""}
    with pytest.raises(KeyError, match="no_such_knob"):
        testUM.main(argv + ["--knob", "no_such_knob=1"])
    assert len(engines) == 2


@pytest.mark.slow
def test_trained_bundle_quality_equals_jax(tiny_trained_setup, tmp_path):
    """A trained bundle (the tiny trained fixture) served by the port: PSNR
    against the clean images within 1e-3 dB of JAX's on the same noise."""
    from instancediff_torch.models.drift_model import CLIPDriftEngine
    from instancediff_torch.sde import DriftSDE

    eng, X0, MU, EMB_, TY, test_batch = tiny_trained_setup
    eng.save(str(tmp_path), "latest")
    jax_ckpt.save_pytree(eng.text_params, str(tmp_path / TEXT_SIDECAR))
    tiny = dict(in_nc=2, out_nc=5, nf=16, ch_mult=[1, 2], context_dim=16,
                text_module="scoremap", score_map_chan=4, if_MultiScoreMap=True,
                num_res_blocks=1)
    port = CLIPDriftEngine(tiny, tiny, score_map_ch_mult=(1, 1), score_map_ngf=16,
                           tiny_text_encoder=True, sde=DriftSDE(T=16, max_sigma=0.3),
                           device="cpu")
    port.load(str(tmp_path), "latest")
    batch = {k: np.asarray(v) for k, v in test_batch.items()}
    key = jax.random.key(11)
    want = np.asarray(eng.test(batch, key, use_ema=True))
    eps, zs = _jax_noise(key, batch["input"].shape, 16)
    got = port.test(batch, init_noise=torch.tensor(eps),
                    step_noise=[torch.tensor(z) for z in zs]).numpy()
    target = np.asarray(X0[:4])
    for j in range(4):
        p_port = eval_restoration(got[j, ..., 0], target[j, ..., 0])["PSNR"]
        p_jax = eval_restoration(want[j, ..., 0], target[j, ..., 0])["PSNR"]
        assert abs(p_port - p_jax) <= 1e-3


def test_export_text_params_writes_the_sidecar(jax_engine, tmp_path, monkeypatch):
    """``tools/export_text_params.py`` builds the JAX engine of the config
    with the training seed (``train.manual_seed``, or ``--seed``) and writes
    its ``text_params`` where the port's ``load`` reads them."""
    import instancediff_tpu.models as jax_models
    from tools import export_text_params

    seeds = []

    def fake_create_model(train_opt, model_opt, phase="train", **kw):
        seeds.append(kw["seed"])  # the real engine build is the fixture's
        return jax_engine

    monkeypatch.setattr(jax_models, "create_model", fake_create_model)
    path = export_text_params.main(["-opt", CONFIG, "--models-dir", str(tmp_path)])
    assert path == str(tmp_path / TEXT_SIDECAR) and seeds == [0]
    jax_ckpt.save_pytree(jax_engine.text_params, str(tmp_path / "want.ckpt"))
    with open(path, "rb") as f, open(tmp_path / "want.ckpt", "rb") as g:
        assert f.read() == g.read()
    export_text_params.main(["-opt", CONFIG, "--models-dir", str(tmp_path), "--seed", "3"])
    assert seeds == [0, 3]
