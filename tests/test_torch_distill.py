"""The PyTorch port's progressive distillation against the JAX package on
the CPU.

Live, per function (no JAX engine): ``distill_grid`` against JAX's for every
student step count at T = 16 and 100 (and the same refusal where 2N > T),
``reverse_step_at`` against JAX's ``reverse_step`` at per-sample timesteps,
and the target algebra of ``tests/test_distill.py`` written with the port's
SDE: two deterministic teacher steps compose exactly into one, and a
stochastic teacher's targets (with the ``-c1 z1`` term) give its
z1-conditioned two-step mean.

The distillation step against the golden that
``tools/make_distill_golden.py`` wrote with JAX's jitted
``build_distill_step`` at ``tiny_cpu.yml``'s widths: two steps from one
seeded student and a second seeded teacher with JAX's draws, per case (fp32
at teacher eta 0 and 1, eta 1 with ``z1_correction``, bf16 at eta 0): the
teacher's composed targets (the teacher on its sampling path, on the CPU
the kernels' plain versions), the loss terms, Adam's first moment and the
parameters, held with ``tests/test_torch_train.py:check_against``'s
tolerances and ``utils/parity.py``. The slow test runs JAX's cases live and
checks the stored golden is current.

Then ``distill_phase`` (the student starts at the teacher, fresh Adam
moments, the step counter restarted, the nets' ``weights_version`` moved so a
compiled sampler captures anew) and ``tools/distill`` end to end on a seeded
port bundle over the port's Synthetic data, its bundles served by
``tools/testUM`` at the student's step count."""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from instancediff_tpu.models.distill import distill_grid as jax_distill_grid
from instancediff_tpu.sde import DriftSDE as JaxDriftSDE

from instancediff_torch.data.synthetic import write_synthetic_index
from instancediff_torch.models import create_model
from instancediff_torch.models.distill import (Teacher, distill_grid, distill_phase,
                                               distill_step, distill_targets, student_step)
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.engine import weights_version
from instancediff_torch.sde import DriftSDE
from instancediff_torch.tools import distill as distill_tool
from instancediff_torch.tools import testUM
from instancediff_torch.utils import checkpoint as ckpt
from instancediff_torch.utils.convert import adam_state, flax_params, load_flax_params
from instancediff_torch.utils.parity import check_grads, check_params, grad_tolerances
from tools import make_distill_golden as golden
from tools import make_train_golden as train_golden

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401
from test_torch_train import (ADAM_CAP, GRAD_FLOOR, GRAD_TOL, REDUCTION_TOL, TOL_BF16, _flat)

GOLDEN = golden.OUT
TARGET_TOL = 1e-4  # the composed targets, fp32, abs
# the fp32 case of a bf16 case's seeded state and draws
FP32_CASE = {"bf16_eta0": "fp32_eta0"}


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("T", [16, 100])
def test_distill_grid_equals_jax(T):
    """Every N with 2N <= T gives JAX's three arrays (no nesting error is
    reachable at these T); every N with 2N > T raises ValueError in both."""
    for n in range(1, T // 2 + 1):
        want = [np.asarray(a) for a in jax_distill_grid(T, n)]
        got = [g.numpy() for g in distill_grid(T, n)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert bool((got[0] > got[1]).all() and (got[1] > got[2]).all())
    for n in (T // 2 + 1, T - 1, T):
        with pytest.raises(ValueError, match="2\\*"):
            jax_distill_grid(T, n)
        with pytest.raises(ValueError, match="2\\*"):
            distill_grid(T, n)


@pytest.mark.parametrize("eta", [0.0, 0.7, 1.0])
def test_reverse_step_at_equals_jax(eta):
    rng = np.random.default_rng(0)
    x, pd, pn, z = (rng.standard_normal((3, 8, 8, 1)).astype(np.float32) for _ in range(4))
    t, tp = np.array([100, 62, 8]), np.array([98, 60, 0])
    want = JaxDriftSDE(T=100, max_sigma=0.4).reverse_step(None, x, t, pd, pn, eta=eta,
                                                          t_prev=tp, z=z)
    got = DriftSDE(T=100, max_sigma=0.4).reverse_step_at(
        *(torch.tensor(a) for a in (x, t, tp, pd, pn)), eta, torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _sd_sg(sde, B):
    bshape = (B, 1, 1, 1)
    return (lambda t: sde.drift_schedule[t].reshape(bshape),
            lambda t: sde.sigmas[t].reshape(bshape))


def test_two_teacher_steps_compose_exactly_into_one():
    """The increment-weighted targets reproduce the teacher's two
    deterministic steps in one (``tests/test_distill.py``'s case)."""
    sde = DriftSDE(T=100, max_sigma=0.4)
    gen = torch.Generator().manual_seed(1)
    x_t, pd1, pn1, pd2, pn2 = (torch.randn(3, 8, 8, 1, generator=gen) for _ in range(5))
    th, tm, tl = torch.tensor([100, 62, 4]), torch.tensor([99, 61, 2]), torch.tensor([98, 60, 0])
    z = torch.zeros_like(x_t)
    x_mid = sde.reverse_step_at(x_t, th, tm, pd1, pn1, 0.0, z)
    x_lo = sde.reverse_step_at(x_mid, tm, tl, pd2, pn2, 0.0, z)
    sd, sg = _sd_sg(sde, 3)
    dsd1, dsd2 = sd(th) - sd(tm), sd(tm) - sd(tl)
    dsg1, dsg2 = sg(th) - sg(tm), sg(tm) - sg(tl)
    d_tgt = (dsd1 * pd1 + dsd2 * pd2) / torch.clamp(dsd1 + dsd2, min=1e-8)
    n_tgt = (dsg1 * pn1 + dsg2 * pn2) / torch.clamp(dsg1 + dsg2, min=1e-8)
    one = sde.reverse_step_at(x_t, th, tl, d_tgt, n_tgt, 0.0, z)
    np.testing.assert_allclose(one.numpy(), x_lo.numpy(), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("teacher_eta", [1.0, 0.7])
def test_stochastic_teacher_composes_into_conditional_mean(teacher_eta):
    """The deterministic one-step with the targets (``-c1 z1`` included)
    equals the teacher's two stochastic steps with the second step's fresh
    noise zeroed."""
    sde = DriftSDE(T=100, max_sigma=0.4)
    gen = torch.Generator().manual_seed(5)
    x_t, pd1, pn1, pd2, pn2, z1 = (torch.randn(3, 8, 8, 1, generator=gen) for _ in range(6))
    th, tm, tl = torch.tensor([100, 62, 8]), torch.tensor([98, 60, 4]), torch.tensor([96, 58, 0])
    zeros = torch.zeros_like(x_t)
    x_mid = sde.reverse_step_at(x_t, th, tm, pd1, pn1, teacher_eta, z1)
    x_lo_mean = sde.reverse_step_at(x_mid, tm, tl, pd2, pn2, teacher_eta, zeros)
    sd, sg = _sd_sg(sde, 3)
    carry1, c1 = sde.posterior_coeffs(sg(th), sg(tm), teacher_eta)
    carry2, _ = sde.posterior_coeffs(sg(tm), sg(tl), teacher_eta)
    dsd1, dsd2 = sd(th) - sd(tm), sd(tm) - sd(tl)
    d_tgt = (dsd1 * pd1 + dsd2 * pd2) / torch.clamp(dsd1 + dsd2, min=1e-8)
    n_tgt = ((sg(th) - carry1) * pn1 + (sg(tm) - carry2) * pn2 - c1 * z1) / torch.clamp(
        sg(th) - sg(tl), min=1e-8)
    one = sde.reverse_step_at(x_t, th, tl, d_tgt, n_tgt, 0.0, zeros)
    np.testing.assert_allclose(one.numpy(), x_lo_mean.numpy(), atol=2e-6, rtol=2e-6)


# ---------------------------------------------------------------- the golden


def port_engine(name, device="cpu"):
    """The port's engine and teacher of a golden case, seeded as the
    golden's JAX engine (``make_train_golden.seeded_state`` over the port's
    flax trees, in ``make_distill_golden.DRAW_ORDER``)."""
    dtype, _, _ = golden.CASES[name]
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    eng = CLIPDriftEngine(train_golden.SETTINGS, train_golden.SETTINGS,
                          sde=DriftSDE(T=train_golden.T, max_sigma=0.4), dtype=dt, device=device,
                          if_train=True, **train_golden.COMMON, **train_golden.DRIFT)
    nets = {k: flax_params(eng.nets[k]) for k in ("drift", "noise")}
    state = train_golden.seeded_state(golden.templates(nets, flax_params(eng.text_encoder)))
    for k in ("drift", "noise"):
        load_flax_params(eng.nets[k], state[k])
        load_flax_params(eng.nets[k[0] + "_ema"], state[k])
    load_flax_params(eng.text_encoder, state["text"])
    teacher_nets = {}
    for k in ("drift", "noise"):
        teacher_nets[k] = copy.deepcopy(eng.nets[k])
        load_flax_params(teacher_nets[k], state["teacher_" + k])
    return eng, Teacher(eng, teacher_nets["drift"], teacher_nets["noise"])


@pytest.fixture(scope="module")
def stored():
    arrays = ckpt.load_pytree(os.path.join(GOLDEN, "golden.ckpt"))
    with open(os.path.join(GOLDEN, "losses.json")) as f:
        losses = json.load(f)
    return arrays, losses


def first_moments(eng) -> dict:
    return {k: adam_state(eng.optimizers[k], eng.nets[k])["inner_state"]["1"]["mu"]
            for k in eng.optimizers}


def run_port(name, eng, teacher, draws):
    """The golden's two steps on ``eng`` with JAX's draws: each step's
    targets and loss terms, and the first moments before and after each.
    In bf16 the student steps on JAX's targets (``draws``' ``d_tgt`` and
    ``n_tgt``): the teacher's bf16 forwards round otherwise than JAX's, and
    their targets are held apart (``check_against``)."""
    dtype, eta, z1c = golden.CASES[name]
    data = train_golden.batch()
    targets, losses, moments = [], [], [first_moments(eng)]
    for i in (1, 2):
        kw = {k: torch.tensor(np.asarray(draws[k][i - 1])) for k in ("pair", "eps", "z1")}
        tg = distill_targets(eng, teacher, data, golden.STUDENT_STEPS, eta, z1c, **kw)
        targets.append({k: tg[k].float().numpy() for k in ("d_tgt", "n_tgt")})
        if dtype == "bfloat16":
            tg = dict(tg, **{k: torch.tensor(np.asarray(draws[k][i - 1]))
                             for k in ("d_tgt", "n_tgt")})
        losses.append(student_step(eng, tg, golden.lr_at(i)))
        moments.append(first_moments(eng))
    return targets, losses, moments


def check_against(name, eng, got, want, want_losses, stored) -> dict:
    """``tests/test_torch_train.py:check_against``'s rules on a distill
    case: the targets within ``TARGET_TOL`` abs in fp32; in bf16 within
    ``TOL_BF16`` of their largest magnitude beyond the distance between
    JAX's bf16 and fp32 targets (the fp32 case ``FP32_CASE``: the same state
    and draws; the teacher's bf16 forwards differ from JAX's by bf16
    roundings, read up to 8.2e-2 of magnitudes up to 3.0, where JAX's own
    bf16 targets lie up to 6.5e-2 from its fp32 ones), the loss terms (fp32 1e-4 relative, bf16
    ``TOL_BF16``), Adam's first moment after step 1 by
    ``parity.check_grads`` and the parameters after step 2 by
    ``parity.check_params``. In bf16 the first moment is held to JAX's fp32
    step (the fp32 case ``FP32_CASE``) within ``TOL_BF16`` of the net's
    largest leaf beyond JAX's own bf16 step's distance from it: the port's
    bf16 step and JAX's round independently, and on the drift net's
    ``smm_0/logit_scale`` (a sum over every pixel, prompt and image) they
    lie on either side of the fp32 step, 2.7e-4 and 3.1e-4 from it, 5.9e-4
    apart, where ``TOL_BF16`` of the largest leaf is 2.3e-4."""
    dtype, _, _ = golden.CASES[name]
    fp32 = dtype == "float32"
    tol = 1e-5 if fp32 else TOL_BF16
    grad_tol = (GRAD_TOL, GRAD_FLOOR, REDUCTION_TOL) if fp32 else (0.0, TOL_BF16, 0.0)
    targets, losses, moments = got
    read = {}
    for i, tg in enumerate(targets):
        for k in ("d_tgt", "n_tgt"):
            w = np.asarray(want[k][i])
            err = float(np.abs(tg[k] - w).max())
            limit = TARGET_TOL
            if not fp32:  # beyond JAX's own bf16 targets' distance from its fp32 ones
                ref = np.asarray(stored[0][FP32_CASE[name]][k][i])
                limit = TOL_BF16 * max(1.0, float(np.abs(w).max())) + float(
                    np.abs(w - ref).max())
            assert err <= limit, f"{name} step {i + 1} {k}: max abs err {err:.3g}"
            read[f"step {i + 1} {k} max abs err"] = err
    for got_l, want_l in zip(losses, want_losses):
        assert sorted(got_l) == sorted(want_l)
        for k in want_l:
            assert got_l[k] == pytest.approx(want_l[k], rel=1e-4 if fp32 else TOL_BF16,
                                             abs=1e-6 if fp32 else TOL_BF16), (name, k)
    keep = (lambda t: t) if name in golden.FULL else train_golden.subset
    lrs = [golden.lr_at(i) for i in (1, 2)]
    for key in ("drift", "noise"):
        want_m, slack = _flat(want["mu1"][key]), None
        if not fp32:  # the fp32 step, beyond JAX's own bf16 step's distance from it
            ref = _flat(train_golden.subset(stored[0][FP32_CASE[name]]["mu1"][key]))
            slack = {k: float(np.abs(v - ref[k]).max()) for k, v in want_m.items()}
            want_m = ref
        _, read[key + " first moment"] = check_grads(
            _flat(keep(moments[1][key])), want_m, *grad_tol, slack=slack,
            what=f"{name} {key} mu1 ")
        m = [_flat(keep(moments[i][key])) for i in range(3)]
        grads = [{k: (m[i + 1][k] - 0.9 * m[i][k]) / 0.1 for k in m[i + 1]} for i in range(2)]
        read[key + " parameters"] = check_params(
            _flat(keep(flax_params(eng.nets[key]))), _flat(want["params"][key]), tol,
            [(lr, g, grad_tolerances(g, *grad_tol)) for lr, g in zip(lrs, grads)],
            ADAM_CAP[dtype], what=f"{name} {key} ")
    return read


@pytest.mark.parametrize("name", list(golden.CASES))
def test_distill_step_matches_jax_golden(name, stored):
    """Two port distill steps from the golden's seeded student and teacher
    with JAX's draws: the targets, the loss terms, the first moments and
    the parameters."""
    arrays, losses = stored
    eng, teacher = port_engine(name)
    check_against(name, eng, run_port(name, eng, teacher, arrays[name]), arrays[name],
                  losses[name], stored)
    assert eng.step == 2
    for p in eng.nets.parameters():  # fp32 master weights, bf16 too
        assert p.dtype == torch.float32
    dt = torch.bfloat16 if golden.CASES[name][0] == "bfloat16" else torch.float32
    assert teacher.drift.conv_in.weight.dtype == dt  # the teacher in the compute dtype


def test_distill_step_draws_from_the_generator(stored):
    """Without injected draws the step draws the pair, eps and z1 from the
    generator in that order: the same seed, the same step."""
    outs = []
    for _ in range(2):
        eng, teacher = port_engine("fp32_eta1")
        outs.append(distill_step(eng, teacher, train_golden.batch(), golden.STUDENT_STEPS,
                                 teacher_eta=1.0, generator=torch.Generator().manual_seed(4),
                                 lr=1e-3))
    assert outs[0] == outs[1] and all(np.isfinite(v) for v in outs[0].values())


def test_distill_refuses_other_optimize_types():
    eng = CLIPDriftEngine(train_golden.SETTINGS, train_golden.SETTINGS,
                          sde=DriftSDE(T=train_golden.T), device="cpu", if_train=True,
                          optimize_type="predict_x0", **train_golden.COMMON,
                          **train_golden.DRIFT)
    with pytest.raises(ValueError, match="inputRes"):
        distill_step(eng, Teacher.from_engine(eng), train_golden.batch(), 4, lr=1e-3)
    with pytest.raises(ValueError, match="inputRes"):
        distill_phase(eng, 4, iter([train_golden.batch()]), 1)


# ---------------------------------------------------------------- the phase


def test_distill_phase_starts_the_student_at_the_teacher(stored):
    """The raw teacher: after a phase of 0 steps the live nets and the EMA
    shadows equal the raw nets it started from; Adam's moments are empty and
    the step counter is 0. One step later the nets' ``weights_version`` has
    moved (a compiled sampler captures anew) and the EMA (step 1 < 10)
    still holds the teacher."""
    eng, _ = port_engine("fp32_eta0")
    for _ in range(2):  # give Adam moments and a step count to forget
        eng.optimize_parameters(train_golden.batch(), torch.Generator().manual_seed(0))
    start = {k: [p.detach().clone() for p in eng.nets[k].parameters()]
             for k in ("drift", "noise")}
    distill_phase(eng, golden.STUDENT_STEPS, iter([]), 0, ema_as_teacher=False)
    for k, ema in (("drift", "d_ema"), ("noise", "n_ema")):
        for net in (k, ema):
            for p, q in zip(eng.nets[net].parameters(), start[k]):
                assert torch.equal(p, q)
    assert eng.step == 0 and all(not opt.state for opt in eng.optimizers.values())
    before = weights_version(eng._step_nets(True)), weights_version(eng._step_nets(False))
    batches = iter([train_golden.batch()] * 2)
    distill_phase(eng, golden.STUDENT_STEPS, batches, 1, lr=1e-3, ema_as_teacher=False,
                  log_every=1, generator=torch.Generator().manual_seed(1))
    assert eng.step == 1 and eng.loss_info["num"] == 1
    assert weights_version(eng._step_nets(False)) != before[1]
    assert weights_version(eng._step_nets(True)) != before[0]  # copied in place
    for p, q in zip(eng.nets["d_ema"].parameters(), start["drift"]):
        assert torch.equal(p, q)


def _tiny_config(tmp_path, **datasets):
    """``tiny_cpu.yml`` with its datasets replaced and the experiment in
    ``tmp_path``."""
    with open("Configurations/tiny_cpu.yml") as f:
        opt = yaml.safe_load(f)
    opt["datasets"] = datasets
    opt["test"].update(pth_dir=str(tmp_path / "models"), iter=3,
                       result_dir=str(tmp_path / "results"))
    path = tmp_path / "tiny.yml"
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path), opt


def test_distill_tool_end_to_end(tmp_path):
    """``tools/distill`` on the CPU: a seeded port bundle of ``tiny_cpu.yml``
    (T=8), its train split the port's ``Synthetic`` mode, phases 4 and 2 of
    2 steps each; each phase's ``distill{N}`` bundle and text sidecar
    written, and ``distill2`` served by ``tools/testUM`` at 2 steps, eta 0."""
    common = dict(resolution=32, emb_dim=16,
                  use_artifact_type=["speckle in OCT", "Gaussian noise in MRI"])
    cfg, opt = _tiny_config(tmp_path, train=dict(mode="Synthetic", max_dataset_size=4,
                                                 batch_size=2, **common))
    eng = create_model(opt["train"], opt["models"]["DriftNoise"], phase="test",
                       image_size=32, device="cpu")
    rng = np.random.default_rng(3)
    for key in ("drift", "noise", "d_ema", "n_ema"):
        load_flax_params(eng.nets[key], train_golden.seeded_tree(flax_params(eng.nets[key]), rng))
    eng.save(str(tmp_path / "models"), 3)
    out = tmp_path / "distilled"
    got = distill_tool.main(["-opt", cfg, "--device", "cpu", "--phases", "4", "2",
                             "--steps-per-phase", "2", "--lr", "1e-3", "--out-dir", str(out)])
    assert got.step == 2 and got.device.type == "cpu"
    names = set(os.listdir(out))
    for n in (4, 2):
        assert {f"distill{n}_DN.ckpt", f"distill{n}_NN.ckpt"} <= names, names
    assert "text_params.ckpt" in names
    index = str(tmp_path / "data" / "dataset_file.json")
    write_synthetic_index(str(tmp_path / "data"), n_train=0, n_val=0, n_test=2, res=32,
                          artifact_types=common["use_artifact_type"], emb_dim=16)
    cfg_test, _ = _tiny_config(tmp_path, test=dict(name="test_dataset", mode="SpeckleMed",
                                                   dataset_file=index, **common))
    res = testUM.main(["-opt", cfg_test, "--device", "cpu", "--pth-dir", str(out), "--iter",
                       "distill2", "--sample-steps", "2", "--eta", "0"])
    assert sum(v["num"] for v in res.values()) == 2
    assert all(np.isfinite(v["PSNR"]).all() for v in res.values() if v["num"])


# ---------------------------------------------------------------- live JAX


@pytest.mark.slow
@pytest.mark.parametrize("name", list(golden.CASES))
def test_distill_step_matches_jax_live_and_golden_is_current(name, stored):
    """JAX's jitted distill step run now: its draws, targets, losses and
    parameters equal the stored golden's, and the port matches them."""
    arrays, losses = stored
    live = golden.run_case(name)
    for k in ("pair", "eps", "z1", "d_tgt", "n_tgt"):
        np.testing.assert_array_equal(live[k], arrays[name][k])
    assert live["losses"] == losses[name]
    for part in ("params", "mu1"):
        for key, tree in live[part].items():
            want, got = _flat(arrays[name][part][key]), _flat(tree)
            assert sorted(want) == sorted(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    eng, teacher = port_engine(name)
    check_against(name, eng, run_port(name, eng, teacher, live), live, live["losses"], stored)

