"""ZeRO-style FSDP of the PyTorch port on the CPU (``instancediff_torch/
parallel/mesh.py``), held against the JAX package's rules and against one
process.

``fsdp_spec`` is JAX's ``_fsdp_spec`` on a grid of shapes; the ``up_*``
leaves stay replicated, as ``FSDP_REPLICATE_PATTERNS`` keeps them in JAX.
One spawned gloo world of four ranks takes the train golden's two drift
fp32 steps (``tests/test_torch_train.py``) on a 2 x 2 dp x fsdp grid (the
batch split over dp, the parameters, Adam's moments and the EMA shadows
split over fsdp) and holds them to the one-process steps: the loss within
1e-5 relative, the first three leaves within rtol 1e-4 / atol 1e-6 (JAX's
``tests/test_parallel.py`` test), and every first moment and parameter by
``utils/parity.py``'s rules (``test_torch_train.check_against``); then on a
1 x 4 grid, where every rank sees the whole batch, the ``.state`` file rank 0
gathers and writes is byte-identical to the one-process run's."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from instancediff_tpu.parallel import make_mesh
from instancediff_tpu.parallel.mesh import _fsdp_spec

from instancediff_torch.models.unet import LearnableForwardUNetMultiScoreMap
from instancediff_torch.parallel.mesh import FSDP_REPLICATE_PATTERNS, fsdp_spec, leaf_spec
from instancediff_torch.utils.convert import flax_params, load_flax_params

import torch_dist_workers as workers
from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401
from test_torch_train import _flat, check_against, port_engine, run_port, stored  # noqa: F401

CASE = "drift_fp32"


@pytest.mark.parametrize("size", [2, 4])
def test_fsdp_spec_is_jax_rule(size):
    """JAX's ``tests/test_parallel.py`` cases ((6, 8) splits dim 1; (3, 5)
    and scalars replicate) and more, against ``_fsdp_spec`` itself."""
    mesh = make_mesh(("dp", "fsdp"), (8 // size, size))
    for shape in [(6, 8), (3, 5), (), (8, 8), (2, 3, 4), (1,), (5, 4, 3, 3), (3, 3, 8, 16),
                  (12,), (2,)]:
        spec = tuple(_fsdp_spec(jnp.zeros(shape), mesh))
        want = spec.index("fsdp") if "fsdp" in spec else None
        assert fsdp_spec(shape, size) == want, shape
    assert fsdp_spec((6, 8), 2) == 1 and fsdp_spec((3, 5), 2) is None
    assert fsdp_spec((), 2) is None and fsdp_spec((6, 8), 1) is None


def test_up_leaves_stay_replicated():
    """JAX's ``test_fsdp_replicates_conv_transpose_kernels``: every ``up_*``
    leaf of the UNet replicated, other leaves split."""
    assert FSDP_REPLICATE_PATTERNS == ("up_",)
    net = LearnableForwardUNetMultiScoreMap(nf=4, ch_mult=(1, 2), context_dim=8,
                                            score_map_chan=2, score_map_ch_mult=(1, 1),
                                            score_map_ngf=4, num_res_blocks=1)
    specs = {n: leaf_spec(n, p.shape, 2) for n, p in net.named_parameters()}
    up = [n for n in specs if "up_" in n]
    assert up and all(specs[n] is None for n in up)
    assert sum(d is not None for d in specs.values()) > len(specs) // 2


def test_dp_fsdp_steps_as_one_process(stored, tmp_path):
    arrays, losses = stored
    draws = {k: np.asarray(v) for k, v in arrays[CASE].items() if k in ("t", "std_noise")}
    started = workers.start_world(workers.fsdp_rank, 4, CASE, draws, str(tmp_path))
    one = port_engine(CASE)
    l_one, m_one = run_port(one, arrays[CASE])
    one.save_training_state(str(tmp_path / "one"), 1, 2)
    ranks = workers.finish_world(started)

    for r in ranks:  # the round trip, and the layout of tests/test_parallel.py
        for grid, size in (("2x2", 2), ("1x4", 4)):
            layout, whole = r[f"roundtrip_{grid}"]
            assert layout == {"w": ((4 // size, 4), 0), "b": ((3,), None)}
            np.testing.assert_array_equal(whole["w"], np.arange(16.0).reshape(4, 4))
            np.testing.assert_array_equal(whole["b"], np.ones(3))
    assert sorted(r["2x2"]["grid"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    got = ranks[0]["2x2"]
    for r in ranks[1:]:  # every rank took the same step
        assert r["2x2"]["losses"] == got["losses"]
        for key in got["params"]:
            f0, f1 = _flat(got["params"][key]), _flat(r["2x2"]["params"][key])
            assert all(np.array_equal(f0[k], f1[k]) for k in f0)
    for g, w in zip(got["losses"], l_one):
        assert g["l"] == pytest.approx(w["l"], rel=1e-5)
    want_params = {k: flax_params(one.nets[k]) for k in got["params"]}
    for key in got["params"]:
        g, w = _flat(got["params"][key]), _flat(want_params[key])
        for leaf in sorted(w)[:3]:
            np.testing.assert_allclose(g[leaf], w[leaf], rtol=1e-4, atol=1e-6)
    eng = port_engine(CASE)
    for key, tree in got["params"].items():
        load_flax_params(eng.nets[key], tree)
    check_against(CASE, eng, (got["losses"], got["mus"]),
                  {"mu1": m_one[1], "params": want_params}, l_one, stored)
    held = got["bytes"]
    assert held["held"] < 0.6 * held["unsharded"]

    whole = ranks[0]["1x4"]
    assert whole["written"] > 0 and all(r["1x4"]["written"] == 0 for r in ranks[1:])
    for name in os.listdir(tmp_path / "one"):
        with open(tmp_path / "one" / name, "rb") as f, open(tmp_path / "1x4" / name, "rb") as h:
            assert f.read() == h.read(), name
    assert os.listdir(tmp_path / "one")
    for g, w in zip(whole["mus"][1:], m_one[1:]):
        for key in w:
            fg, fw = _flat(g[key]), _flat(w[key])
            assert all(np.array_equal(fg[k], fw[k]) for k in fw)
