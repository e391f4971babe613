"""The PyTorch port's pinned-manifest evaluation on the CPU: the manifest
tool against the JAX package's ``tools/eval_manifest.py`` (the same bytes,
the same CLI, the same report on ``dataset/flagship224``, whose 691 files
are not in the repository), and ``tools/eval_protocol`` end to end on a
seeded tiny port bundle over a 32 px port Synthetic set: its JSON record and
table, its refusal of a changed file, and ``--regen``'s refusal of JAX's
generator line and its rebuild from the port's."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from tools import eval_manifest as jax_manifest
from tools import make_train_golden as train_golden

from instancediff_torch.models import create_model
from instancediff_torch.tools import eval_manifest, eval_protocol, make_synth_dataset
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401

FLAGSHIP_SET = "dataset/flagship224"
TYPES = ["speckle in OCT", "Gaussian noise in MRI"]


def _tree(root):
    """A small tree of files in two directories."""
    os.makedirs(os.path.join(root, "sub"))
    rng = np.random.default_rng(0)
    for name in ("b.raw", "a.json", "sub/c.raw", "sub/a.raw"):
        with open(os.path.join(root, name), "wb") as f:
            f.write(rng.bytes(64))


@pytest.mark.parametrize("generator", [None, "python -m x --root 'a b'"])
def test_manifest_bytes_equal_jax(tmp_path, monkeypatch, generator):
    """``write_manifest`` and the ``write`` command give JAX's bytes;
    ``verify`` agrees with JAX's on a good and a changed tree."""
    _tree(tmp_path / "t")
    jax_manifest.write_manifest(str(tmp_path / "t"), generator)
    want = (tmp_path / "t" / eval_manifest.MANIFEST_NAME).read_bytes()
    os.remove(tmp_path / "t" / eval_manifest.MANIFEST_NAME)
    path, n = eval_manifest.write_manifest(str(tmp_path / "t"), generator)
    assert n == 4 and open(path, "rb").read() == want
    os.remove(path)
    eval_manifest.main(["write", str(tmp_path / "t")] + (
        ["--generator", generator] if generator else []))
    assert open(path, "rb").read() == want
    assert eval_manifest.verify_manifest(str(tmp_path / "t")) == jax_manifest.verify_manifest(
        str(tmp_path / "t"))
    with open(tmp_path / "t" / "sub" / "c.raw", "ab") as f:
        f.write(b"x")
    got = eval_manifest.verify_manifest(str(tmp_path / "t"))
    assert got == jax_manifest.verify_manifest(str(tmp_path / "t"))
    assert got[:2] == (False, ["hash mismatch: sub/c.raw"])
    with pytest.raises(SystemExit):
        eval_manifest.main(["verify", str(tmp_path / "t")])


def test_verify_reports_the_flagship_sets_missing_files():
    """The pinned flagship set's manifest is in the repository and its files
    are not: 691 missing, and JAX's generator line, as JAX's tool reports."""
    ok, problems, generator = eval_manifest.verify_manifest(FLAGSHIP_SET)
    assert not ok and len(problems) == 691
    assert all(p.startswith("missing: ") for p in problems)
    assert generator == ("python tools/make_synth_dataset.py --root dataset/flagship224 "
                         "--res 224 --n-train 200 --n-val 5 --n-test 25 --emb-dim 512 --seed 0")
    assert (ok, problems, generator) == jax_manifest.verify_manifest(FLAGSHIP_SET)


@pytest.fixture
def bundle_and_set(tmp_path, monkeypatch):
    """In ``tmp_path`` (the working directory): a seeded port bundle of
    ``tiny_cpu.yml`` (iteration 3, with its text sidecar), a 32 px port
    Synthetic set of 2 test images per type with its manifest, and a config
    whose test split is that set."""
    repo = os.getcwd()
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(repo, "Configurations", "tiny_cpu.yml")) as f:
        opt = yaml.safe_load(f)
    make_synth_dataset.main(["--root", "set", "--res", "32", "--n-train", "0", "--n-val", "0",
                             "--n-test", "4", "--emb-dim", "16", "--types", *TYPES])
    opt["datasets"] = {"test": dict(name="test_dataset", mode="SpeckleMed",
                                    dataset_file="set/dataset_file.json",
                                    resolution=32, emb_dim=16, use_artifact_type=TYPES)}
    opt["test"].update(pth_dir="models", iter=3, result_dir="results", batch_size=2)
    with open("tiny.yml", "w") as f:
        yaml.safe_dump(opt, f)
    eng = create_model(None, opt["models"]["DriftNoise"], phase="test", image_size=32,
                       device="cpu")
    rng = np.random.default_rng(4)
    for key in ("drift", "noise", "d_ema", "n_ema"):
        load_flax_params(eng.nets[key], train_golden.seeded_tree(flax_params(eng.nets[key]), rng))
    eng.save("models", 3)
    return tmp_path


def test_eval_protocol_end_to_end(bundle_and_set, capsys):
    """A verified set: testUM on the CPU at 2 steps, eta 0; the record holds
    the manifest's digest, the sampler settings and per-type means of 2
    images each; the table is printed."""
    args = ["--opt", "tiny.yml", "--dataset-root", "set", "--tag", "tiny", "--sample-steps",
            "2", "--eta", "0", "--device", "cpu", "--out-dir", "out"]
    record = eval_protocol.main(args)
    with open(os.path.join("out", "eval_tiny.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(record))
    assert saved["manifest_sha256"] == eval_protocol.manifest_digest("set")
    assert (saved["sample_steps"], saved["eta"], saved["device"]) == (2, 0.0, "cpu")
    assert sorted(saved["table"]) == sorted(TYPES)
    for row in saved["table"].values():
        assert row["n"] == 2 and np.isfinite([row["PSNR"], row["SSIM"], row["RMSE"]]).all()
    out = capsys.readouterr().out
    assert "| Modality | PSNR | SSIM | RMSE | n | (tiny, manifest" in out
    assert all(f"| {t} |" in out for t in TYPES)


def test_eval_protocol_needs_cuda_unless_cpu_is_asked(bundle_and_set, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_protocol.main(["--opt", "tiny.yml", "--dataset-root", "set", "--tag", "t",
                            "--out-dir", "out"])


def test_eval_protocol_refuses_a_changed_set(bundle_and_set):
    with open(os.path.join("set", "test_0_B.raw"), "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(SystemExit, match="does not match its pinned manifest"):
        eval_protocol.main(["--opt", "tiny.yml", "--dataset-root", "set", "--tag", "t",
                            "--device", "cpu", "--out-dir", "out"])
    assert not os.path.exists("out")


def test_regen_refuses_jax_generator_and_rebuilds_from_the_ports(bundle_and_set):
    """A set pinned with JAX's generator line does not verify once a file is
    gone, and ``--regen`` refuses to run that line; the port's own line
    rebuilds the missing file and the protocol then scores."""
    manifest = os.path.join("set", eval_manifest.MANIFEST_NAME)
    lines = open(manifest).read().splitlines()
    port_line = lines[0]
    jax_line = ("# generator: python tools/make_synth_dataset.py --root set --res 32 "
                "--n-train 0 --n-val 0 --n-test 4 --emb-dim 16 --seed 0")
    with open(manifest, "w") as f:
        f.write("\n".join([jax_line] + lines[1:]) + "\n")
    os.remove(os.path.join("set", "test_1_A.raw"))
    args = ["--opt", "tiny.yml", "--dataset-root", "set", "--tag", "t", "--sample-steps", "2",
            "--eta", "0", "--device", "cpu", "--out-dir", "out", "--regen"]
    with pytest.raises(SystemExit, match="runs the JAX package"):
        eval_protocol.main(args)
    with open(manifest, "w") as f:
        f.write("\n".join([port_line] + lines[1:]) + "\n")
    record = eval_protocol.main(args)
    assert eval_manifest.verify_manifest("set")[0]
    assert sum(row["n"] for row in record["table"].values()) == 4
    shutil.rmtree("out")


def test_manifest_cli_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """The ``verify`` command's report on a good tree, as JAX's prints it."""
    _tree(tmp_path / "t")
    eval_manifest.write_manifest(str(tmp_path / "t"), "gen")
    eval_manifest.main(["verify", str(tmp_path / "t")])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["eval_manifest.py", "verify", str(tmp_path / "t")])
    jax_manifest.main()
    assert got == capsys.readouterr().out == f"manifest OK: {tmp_path / 't'} (generator: gen)\n"
