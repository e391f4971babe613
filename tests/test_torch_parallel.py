"""The port's data parallelism on the CPU over gloo: ``instancediff_torch/
parallel``, the whole ``DistIterSampler`` and ``trainUM --launcher
pytorch``, held against the JAX package.

The sampler equals JAX's exactly over a grid of sizes, replicas, ranks,
ratios and epochs. A 2-rank world (two spawned processes, each fed its
half of the train golden's batch and of its injected draws) takes the
golden's two steps: the ranks end bit-identical, and their step equals the
1-process step on the global batch and JAX's golden under
``instancediff_torch/utils/parity.py``'s rules (``test_torch_train.
check_against``: the mean of two half-batch gradients differs from one
mean in the last bits, which Adam amplifies where a gradient is roundoff).
A 2-rank ``trainUM`` writes one experiment, logs ``world_size=2`` and
leaves both ranks' weights equal, the ranks drawing different timesteps. A
world of one is bit-identical to no world."""

import os

import numpy as np
import pytest
import torch

from instancediff_tpu.data.sampler import DistIterSampler as JaxSampler

from instancediff_torch import data as data_pkg
from instancediff_torch import parallel
from instancediff_torch.utils.convert import flax_params, load_flax_params

import torch_dist_workers as workers
from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401
from test_torch_train import _flat, check_against, port_engine, run_port, stored  # noqa: F401
from test_torch_trainum import write_config

# the train golden's two full cases: drift fp32, DDPM fp32 with on-device degradation
CASES = ("drift_fp32", "ddpm_fp32_degrade")


@pytest.mark.parametrize("size", [1, 7, 10, 13])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("ratio", [1, 1.5, 3])
def test_sampler_equals_jax(size, replicas, ratio):
    seen = []
    for rank in range(replicas):
        port = data_pkg.DistIterSampler(size, num_replicas=replicas, rank=rank, ratio=ratio)
        want = JaxSampler(size, num_replicas=replicas, rank=rank, ratio=ratio)
        assert len(port) == len(want)
        for epoch in (0, 1, 5):
            port.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(port) == list(want)
        seen += list(port)
    assert set(seen) == set(range(size))
    with pytest.raises(ValueError):
        data_pkg.DistIterSampler(size, num_replicas=replicas, rank=replicas)


def test_one_replica_is_the_dataset_permutation():
    s = data_pkg.DistIterSampler(9)
    s.set_epoch(4)
    assert list(s) == np.random.default_rng(4).permutation(9).tolist() and len(s) == 9


def test_train_loader_loads_its_part_of_the_global_batch(tmp_path):
    from instancediff_torch.config import parse

    opt = parse(write_config(tmp_path), is_train=True)["datasets"]["train"]
    ds = data_pkg.create_dataset(opt)
    loaders = [data_pkg.create_dataloader(ds, opt, data_pkg.DistIterSampler(len(ds), 2, r), 2)
               for r in range(2)]
    batches = [list(loader) for loader in loaders]
    assert [len(b) for b in batches] == [2, 2]
    assert all(len(b["GT_path"]) == opt["batch_size"] // 2 for bs in batches for b in bs)
    assert {p for bs in batches for b in bs for p in b["GT_path"]} == {r["B"] for r in ds.df}
    with pytest.raises(ValueError, match="divide"):
        data_pkg.create_dataloader(ds, dict(opt, batch_size=3), None, 2)


def test_shard_batch_and_buckets():
    batch = {"x": np.arange(12).reshape(6, 2), "t": torch.arange(6), "names": list("abcdef")}
    parts = [parallel.shard_batch(batch, r, 3) for r in range(3)]
    assert [p["names"] for p in parts] == [["a", "b"], ["c", "d"], ["e", "f"]]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    whole = parallel.shard_batch(batch)  # no group: the whole batch
    assert whole["names"] == batch["names"] and torch.equal(whole["t"], batch["t"])
    with pytest.raises(ValueError, match="split"):
        parallel.shard_batch(batch, 0, 4)
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(3, dtype=torch.float64), torch.zeros(40)]
    runs = list(parallel._buckets(ts, 100))
    assert [[id(t) for t in r] for r in runs] == [[id(ts[0]), id(ts[1])], [id(ts[2])],
                                                  [id(ts[3])]]


def test_helpers_do_nothing_without_a_group():
    assert (parallel.world_size(), parallel.rank(), parallel.is_rank0()) == (1, 0, True)
    t = torch.arange(4.0)
    assert parallel.all_reduce_mean_([t]) == 0 and torch.equal(t, torch.arange(4.0))
    assert parallel.broadcast_module_(torch.nn.Linear(2, 2)) == 0
    assert parallel.any_rank(True) and not parallel.any_rank(False)
    parallel.barrier()


def test_world_of_one_is_bit_identical_to_no_world(stored):
    """The golden's steps in a gloo world of one (the launcher's environment
    absent: a free localhost port) against the same steps without one."""
    arrays, _ = stored
    want = run_port(port_engine(CASES[0]), arrays[CASES[0]])
    parallel.init_distributed("cpu")
    try:
        assert parallel.world_size() == 1
        eng = port_engine(CASES[0])
        got = run_port(eng, arrays[CASES[0]])
    finally:
        parallel.shutdown()
    assert not torch.distributed.is_initialized()
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        for key in w:
            fg, fw = _flat(g[key]), _flat(w[key])
            assert all(np.array_equal(fg[k], fw[k]) for k in fw)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_two_ranks_step_as_one_process_and_as_jax(stored):
    arrays, losses = stored
    cases = {name: {k: np.asarray(v) for k, v in arrays[name].items()
                    if k in ("t", "std_noise", "deg_noise")} for name in CASES}
    ranks = workers.run_world(workers.golden_rank, 2, cases)
    assert [(r["world"], r["rank"]) for r in ranks] == [(2, 0), (2, 1)]
    assert all(r["any_rank1"] and not r["any_none"] for r in ranks)
    for name in CASES:
        (l0, m0, p0), (l1, m1, p1) = ranks[0][name], ranks[1][name]
        assert l0 == l1  # the recorded losses are the global batch's, on every rank
        for key in p0:  # the ranks end bit-identical (rank 1's perturbation undone)
            f0, f1 = _flat(p0[key]), _flat(p1[key])
            assert all(np.array_equal(f0[k], f1[k]) for k in f0), (name, key)
        eng = port_engine(name)
        for key, tree in p0.items():
            load_flax_params(eng.nets[key], tree)
        # against the 1-process step on the global batch
        one = port_engine(name)
        l_one, m_one = run_port(one, arrays[name])
        check_against(name, eng, (l0, m0), {
            "mu1": m_one[1], "params": {k: flax_params(one.nets[k]) for k in p0}}, l_one,
            stored)
        # and so against JAX's golden
        check_against(name, eng, (l0, m0), arrays[name], losses[name], stored)


def test_trainum_on_two_ranks(tmp_path):
    cfg = write_config(tmp_path)
    ranks = workers.run_world(workers.trainum_rank, 2, cfg, str(tmp_path))
    assert [r["step"] for r in ranks] == [4, 4]
    for key in ranks[0]["params"]:
        f0, f1 = _flat(ranks[0]["params"][key]), _flat(ranks[1]["params"][key])
        assert all(np.array_equal(f0[k], f1[k]) for k in f0), key
    assert len(ranks[0]["t"]) == len(ranks[1]["t"]) == 4
    assert ranks[0]["t"] != ranks[1]["t"]  # the ranks' draws are not correlated
    exp = tmp_path / "experiments"
    assert os.listdir(exp) == ["tiny_cpu_e2e"]  # one experiment, none archived
    assert (exp / "tiny_cpu_e2e" / "models" / "latest_DN.ckpt").is_file()
    assert (exp / "tiny_cpu_e2e" / "val_images" / "4_0_96x32x1.raw").is_file()
    logs = [f for f in os.listdir(exp / "tiny_cpu_e2e") if f.startswith("train_")]
    assert len(logs) == 1
    with open(exp / "tiny_cpu_e2e" / logs[0]) as f:
        assert "world_size=2" in f.read()
