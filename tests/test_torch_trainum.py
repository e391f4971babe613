"""The port's training driver ``instancediff_torch/tools/trainUM.py`` on the
CPU (``--platform cpu``) at ``Configurations/tiny_cpu.yml``'s widths over
SpeckleMed phantoms (``chip_smoke.write_speckle_med``): a run preempted by
SIGTERM at iteration 2 and resumed from its state equals the uninterrupted
run bit for bit; the train loader's order is JAX's ``DistIterSampler``'s;
``train.dist`` without a launcher is a world of one, bit for bit; ``parse``/``check_resume``/``dict2str`` equal the
JAX package's."""

import os
import signal

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from instancediff_tpu.config import options as jax_options
from instancediff_tpu.data.sampler import DistIterSampler as JaxSampler

from instancediff_torch import data as data_pkg
from instancediff_torch.config import check_resume, dict2str, parse
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.tools import trainUM

from test_torch_engine import one_torch_thread  # noqa: F401

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "Configurations", "tiny_cpu.yml")
NAMES = ["speckle in OCT", "Gaussian noise in MRI"]


def write_config(tmp_path, **train) -> str:
    """tiny_cpu.yml over phantoms in ``tmp_path``, the experiment under it,
    a checkpoint every 2 iterations (one epoch: 4 images, batch 2)."""
    with open(CONFIG) as f:
        opt = yaml.safe_load(f)
    index = chip_smoke.write_speckle_med(str(tmp_path / "data"), 2, 32, 16, NAMES)
    for d in opt["datasets"].values():
        d["dataset_file"] = index
    opt["path"]["root"] = str(tmp_path)
    opt["logger"]["save_checkpoint_freq"] = 2
    opt["train"].update(train)
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def _assert_same_training(a, b):
    assert a.step == b.step
    for key in a.nets:
        for (name, p), q in zip(a.nets[key].named_parameters(), b.nets[key].parameters()):
            assert torch.equal(p, q), f"{key}.{name}"
    for key, opt in a.optimizers.items():
        for p, q in zip(a.nets[key].parameters(), b.nets[key].parameters()):
            sa, sb = opt.state[p], b.optimizers[key].state[q]
            assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_preempted_and_resumed_run_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = write_config(tmp_path)
    whole = trainUM.main(["-opt", cfg, "--platform", "cpu"])
    assert whole.step == 4 and os.path.isfile(
        tmp_path / "experiments" / "tiny_cpu_e2e" / "val_images" / "4_0_96x32x1.raw")

    step = CLIPDriftEngine.optimize_parameters

    def preempt_at_2(self, *args, **kwargs):
        loss = step(self, *args, **kwargs)
        if self.step == 2:
            signal.raise_signal(signal.SIGTERM)  # the driver saves and returns
        return loss

    with monkeypatch.context() as m:
        m.setattr(CLIPDriftEngine, "optimize_parameters", preempt_at_2)
        cut = trainUM.main(["-opt", cfg, "--platform", "cpu"])
    assert cut.step == 2
    state_dir = tmp_path / "experiments" / "tiny_cpu_e2e" / "training_state"
    with open(cfg) as f:
        opt = yaml.safe_load(f)
    opt["path"]["resume_state"] = str(state_dir / "2.state")
    with open(cfg, "w") as f:
        yaml.safe_dump(opt, f)
    resumed = trainUM.main(["-opt", cfg, "--platform", "cpu"])
    assert resumed.ema_restored
    _assert_same_training(whole, resumed)


def test_train_loader_order_is_jax_sampler_order(tmp_path):
    opt = parse(write_config(tmp_path), is_train=True)
    dataset_opt = opt["datasets"]["train"]
    dataset = data_pkg.create_dataset(dataset_opt)
    loader = data_pkg.create_dataloader(dataset, dataset_opt,
                                        data_pkg.DistIterSampler(len(dataset)))
    ref = JaxSampler(len(dataset))
    for epoch in range(3):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        order = list(ref)
        got = [name for b in loader for name in b["GT_path"]]
        assert got == [dataset.df[i]["B"] for i in order]
    for n in (1, 7, 10):
        port, jax_s = data_pkg.DistIterSampler(n), JaxSampler(n)
        port.set_epoch(5)
        jax_s.set_epoch(5)
        assert list(port) == list(jax_s) and len(port) == len(jax_s)


def test_dist_training_raises(tmp_path, monkeypatch):
    """``train.dist: true`` without a launcher trains in a gloo world of one,
    bit for bit as without it, and leaves no process group behind; a
    global batch that does not divide over the ranks raises."""
    monkeypatch.chdir(tmp_path)
    runs = []
    for sub, dist in (("plain", False), ("dist", True)):
        (tmp_path / sub).mkdir()
        runs.append(trainUM.main(["-opt", write_config(tmp_path / sub, dist=dist),
                                  "--platform", "cpu"]))
    assert not torch.distributed.is_initialized()
    _assert_same_training(*runs)
    opt = parse(write_config(tmp_path), is_train=True)["datasets"]["train"]
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        data_pkg.create_dataloader(data_pkg.create_dataset(opt), opt, None, world_size=4)


def test_options_equal_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = write_config(tmp_path)
    for is_train in (True, False):
        got, want = parse(cfg, is_train), jax_options.parse(cfg, is_train)
        assert got == want and dict2str(got) == jax_options.dict2str(want)
    got, want = parse(cfg), jax_options.parse(cfg)
    got["path"]["resume_state"] = want["path"]["resume_state"] = "x/6.state"
    assert check_resume(got, 6) == jax_options.check_resume(want, 6)
    assert np.all([got["path"][f"pretrain_model_{t}"].endswith(f"6_{t}.ckpt")
                   for t in ("DN", "NN", "DP", "NP")])
