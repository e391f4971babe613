"""The PyTorch port's training against the JAX package on the CPU.

Live, per function (no JAX engine): the drift and DDPM forward diffusions
(JAX draws t and the noise from its split keys, the port takes them as
tensors), ``downsample_label``, ``apply_degradation`` with JAX's noises,
the Adam step against optax's ``make_adam`` (and the state mapping), the
cosine learning rate, the EMA and ``_net_io`` for every ``optimize_type``.

The whole train step against the golden that ``tools/make_train_golden.py``
wrote with JAX's jitted ``build_train_step`` at ``tiny_cpu.yml``'s widths:
two steps from one seeded state with JAX's draws, every case of
``CASES``: the losses, the gradient (Adam's first moment) and the
parameters after two steps (tolerances in ``check_against``). The golden's
JAX-written training state resumes in the port, whose re-save is JAX's very
bytes. The slow test runs the JAX cases
live and checks the stored golden is current."""

import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from instancediff_tpu.models import drift_model as jax_drift
from instancediff_tpu.ops.degradations import apply_degradation as jax_apply_degradation
from instancediff_tpu.ops.resize import downsample_label as jax_downsample_label
from instancediff_tpu.sde import DDPMSDE as JaxDDPMSDE
from instancediff_tpu.sde import DriftSDE as JaxDriftSDE
from instancediff_tpu.utils import checkpoint as jax_ckpt

from instancediff_torch.models import unet as unet_mod
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.engine import TEXT_SIDECAR
from instancediff_torch.models.optim import cosine_annealing_lr, ema_update, make_adam, set_lr
from instancediff_torch.ops.degradations import apply_degradation
from instancediff_torch.ops.resize import downsample_label
from instancediff_torch.sde import DDPMSDE, DriftSDE
from instancediff_torch.utils import checkpoint as ckpt
from instancediff_torch.utils.convert import (adam_state, engine_state, flax_params,
                                              flax_state_dict, load_adam_state, load_engine,
                                              load_flax_params, torch_values)
from instancediff_torch.utils.parity import check_grads, check_params, grad_tolerances
from tools import make_train_golden as golden

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401

GOLDEN = golden.OUT
TOL_BF16 = 1e-2
# fp32 first moments: per leaf, with a roundoff floor and the large
# reductions' own tolerance (``check_against``)
GRAD_TOL, GRAD_FLOOR, REDUCTION_TOL = 1e-4, 1e-5, 2e-3
# the most elements per net whose parameter may take Adam's allowance
ADAM_CAP = {"float32": 16, "bfloat16": 64}
# the fp32 case of a bf16 case's seeded state and draws
FP32_CASE = {"drift_bf16": "drift_fp32"}


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------- functions


@pytest.mark.parametrize("kind", ["drift", "ddpm"])
def test_forward_diffusion_equals_jax(kind):
    rng = _rng(0)
    x0 = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    mu = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    key = jax.random.key(5)
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (3,), 1, 101))
    noise = np.asarray(jax.random.normal(kn, x0.shape))
    if kind == "drift":
        jsde, sde = JaxDriftSDE(T=100, max_sigma=0.4), DriftSDE(T=100, max_sigma=0.4)
        want = jax.jit(jsde.forward_diffusion)(key, x0, mu)
        got = sde.forward_diffusion(torch.tensor(x0), torch.tensor(mu), t=torch.tensor(t),
                                    std_noise=torch.tensor(noise))
        jm, js = jsde.marginal(x0, mu, t)
        m, s = sde.marginal(torch.tensor(x0), torch.tensor(mu), torch.tensor(t))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(s.shape))
    else:
        jsde, sde = JaxDDPMSDE(T=100, max_sigma=1.0), DDPMSDE(T=100, max_sigma=1.0)
        want = jax.jit(jsde.forward_diffusion)(key, x0, mu)
        got = sde.forward_diffusion(torch.tensor(x0), torch.tensor(mu), t=torch.tensor(t),
                                    eps=torch.tensor(noise))
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_forward_diffusion_draws_from_the_generator():
    sde = DriftSDE(T=8)
    x0 = torch.zeros(4, 8, 8, 1)
    a, b = (sde.forward_diffusion(x0, x0 + 1, torch.Generator().manual_seed(3))
            for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].shape == (4, 1, 1, 1) and 1 <= int(a[0].min()) and int(a[0].max()) <= 8


def test_reverse_ode_is_the_eta_0_sampler():
    sde, mu = DriftSDE(T=8), torch.linspace(-1, 1, 2 * 8 * 8).reshape(2, 8, 8, 1)

    def predict(x, row):
        return 0.5 * (mu - x), 0.1 * x

    noise = torch.randn(9, *mu.shape, generator=torch.Generator().manual_seed(0))
    kw = dict(init_noise=noise[0], step_noise=list(noise[1:]))
    assert torch.equal(sde.reverse_ode(mu, predict, **kw),
                       sde.reverse_ddpm(mu, predict, eta=0.0, **kw))


@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (1, 37, 45, 2), (1, 64, 48, 1),
                                   (2, 17, 16, 3)])
@pytest.mark.parametrize("mult", [1, 2, 4, 8])
def test_downsample_label_equals_jax(shape, mult):
    x = _rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_downsample_label(jnp.asarray(x), mult))
    got = downsample_label(torch.tensor(x), mult).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_degradation_equals_jax():
    x = _rng(2).uniform(-1, 1, (5, 16, 16, 1)).astype(np.float32)
    type_idx = np.array([0, 1, 2, 3, 4], np.int32)[::-1].copy()
    key = jax.random.key(11)
    want = np.asarray(jax.jit(jax_apply_degradation)(key, jnp.asarray(x),
                                                    jnp.asarray(type_idx)))
    noise = [torch.tensor(np.asarray(jax.random.normal(k, x.shape)))
             for k in jax.random.split(key, 5)]
    got = apply_degradation(torch.tensor(x), torch.tensor(type_idx), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_adam_equals_optax_over_steps_with_a_learning_rate_change():
    """Three steps, the learning rate changed after the first; the moments
    and the step count map onto optax's state (``adam_state``) and back."""
    rng = _rng(3)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Conv2d(3, 2, 3))
    params = flax_params(net)
    grads = [flax_params(net, {n: torch.tensor(rng.standard_normal(tuple(p.shape)),
                                               dtype=torch.float32)
                               for n, p in net.named_parameters()}) for _ in range(3)]
    lrs = [1e-2, 3e-3, 3e-3]
    tx = jax_drift.make_adam(lrs[0], 0.9, 0.99, 1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = jax.jit(tx.init)(jp)
    opt = make_adam(net.parameters(), lrs[0], 0.9, 0.99, 1e-2)

    @jax.jit
    def step(g, state, p, lr):  # the JAX engine's update, with its LR injection
        state.hyperparams["learning_rate"] = lr
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g, lr in zip(grads, lrs):
        jp, state = step(g, state, jp, jnp.asarray(lr, jnp.float32))
        values = torch_values(net, g)
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(values[n])
        set_lr(opt, lr)
        opt.step()
    _assert_trees_close(flax_params(net), jax.tree.map(np.asarray, jp), 1e-6)
    want = jax.tree.map(np.asarray, flax_state_dict(state))
    got = adam_state(opt, net)
    assert int(got["count"]) == int(want["count"]) == 3
    assert float(got["hyperparams"]["learning_rate"]) == float(want["hyperparams"]["learning_rate"])
    for m in ("mu", "nu"):
        _assert_trees_close(got["inner_state"]["1"][m], want["inner_state"]["1"][m], 1e-6)
    fresh = make_adam(net.parameters(), 1.0, 0.9, 0.99, 1e-2)
    load_adam_state(fresh, net, want)
    for p in net.parameters():
        assert float(fresh.state[p]["step"]) == 3.0
        assert torch.allclose(fresh.state[p]["exp_avg"], opt.state[p]["exp_avg"], atol=1e-7)
    assert fresh.param_groups[0]["lr"] == pytest.approx(3e-3)


def test_cosine_annealing_lr_equals_jax():
    for epoch in (0, 1, 7, 250, 499, 500):
        assert cosine_annealing_lr(epoch, 500, 2e-5, 1e-6) == pytest.approx(
            float(jax_drift.cosine_annealing_lr(epoch, 500, 2e-5, 1e-6)), rel=1e-12)


@pytest.mark.parametrize("step", [1, 10, 99, 100, 110])
def test_ema_update_equals_jax(step):
    rng = _rng(4)
    net, ema = torch.nn.Linear(5, 4), torch.nn.Linear(5, 4)
    for m in (net, ema):
        load_flax_params(m, {"params": {"kernel": rng.standard_normal((5, 4)).astype(np.float32),
                                        "bias": rng.standard_normal(4).astype(np.float32)}})
    want = jax_drift._ema_update(jax.tree.map(jnp.asarray, flax_params(ema)),
                                 jax.tree.map(jnp.asarray, flax_params(net)), jnp.int32(step))
    ema_update(ema, net, step)
    _assert_trees_close(flax_params(ema), jax.tree.map(np.asarray, want), 1e-7)


@pytest.mark.parametrize("optimize_type", ["inputRes", "predict_noise", "",
                                           "predict_std_noise_acc_drift",
                                           "predict_std_noise_scale_drift", "predict_x0"])
def test_net_io_equals_jax(optimize_type):
    rng = _rng(5)
    x_t, mu, x0 = (rng.uniform(-1, 1, (2, 8, 8, 1)).astype(np.float32) for _ in range(3))
    t = np.array([3, 7]).reshape(2, 1, 1, 1)
    jsde, sde = JaxDriftSDE(T=8), DriftSDE(T=8)
    drift = np.asarray(jsde.drift_schedule)[t] * (mu - x0)
    fake = type("Engine", (), {"optimize_type": optimize_type, "sde": jsde})()
    want = jax_drift.CLIPDriftEngine._net_io(fake, x_t, mu, x0, drift, jnp.asarray(t))
    fake_port = type("Engine", (), {"optimize_type": optimize_type, "sde": sde,
                                    "_net_inputs": CLIPDriftEngine._net_inputs})()
    got = CLIPDriftEngine._net_io(fake_port, *(torch.tensor(a) for a in (x_t, mu, x0, drift)),
                                  torch.tensor(t))
    flat_w, flat_g = jax.tree.leaves(want), [a for a in _leaves(got) if a is not None]
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


def _assert_trees_close(got, want, rtol, what="", atol=0.0):
    """Every leaf of ``got`` within ``atol`` plus ``rtol`` of the largest
    magnitude of ``want``'s leaf; the same paths."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= atol + rtol * scale, f"{what}{k}: max abs err {err:.3g}, scale {scale:.3g}"


# ---------------------------------------------------------------- the train step


def port_engine(name, device="cpu"):
    """The port's engine of a golden case, seeded as the golden's JAX engine
    (``golden.seeded_state`` over the port's flax trees)."""
    kind, dtype, kw = golden.CASES[name]
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    sde_cls, cls, extra = ((DriftSDE, CLIPDriftEngine, golden.DRIFT) if kind == "drift"
                           else (DDPMSDE, CLIPDDPMEngine, golden.DDPM))
    nets = (golden.SETTINGS, golden.SETTINGS) if kind == "drift" else (golden.SETTINGS,)
    eng = cls(*nets, sde=sde_cls(T=golden.T, max_sigma=golden.MAX_SIGMA[kind]), dtype=dt,
              device=device, if_train=True, **golden.COMMON, **extra, **kw)
    keys = golden.trained_keys(kind)
    state = golden.seeded_state({**{k: flax_params(eng.nets[k]) for k in keys},
                                 "text": flax_params(eng.text_encoder)})
    for k in keys:
        load_flax_params(eng.nets[k], state[k])
        load_flax_params(eng.nets[k[0] + "_ema"], state[k])
    load_flax_params(eng.text_encoder, state["text"])
    return eng


@pytest.fixture(scope="module")
def stored():
    arrays = ckpt.load_pytree(os.path.join(GOLDEN, "golden.ckpt"))
    with open(os.path.join(GOLDEN, "losses.json")) as f:
        losses = json.load(f)
    return arrays, losses


def first_moments(eng) -> dict:
    """Each trained net's Adam first moment in the flax layout."""
    return {k: adam_state(eng.optimizers[k], eng.nets[k])["inner_state"]["1"]["mu"]
            for k in eng.optimizers}


def run_port(eng, draws, steps=(1, 2), device="cpu"):
    """The golden's steps on ``eng`` with JAX's draws: the loss terms of
    each step, and the first moments before the first and after each."""
    data = golden.batch()
    losses, moments = [], [first_moments(eng)]
    for i in steps:
        kw = {k: torch.tensor(np.asarray(draws[k][i - 1]), device=device)
              for k in ("t", "std_noise") if k in draws}
        if "deg_noise" in draws:
            kw["deg_noise"] = list(torch.tensor(np.asarray(draws["deg_noise"][i - 1]),
                                                device=device))
        eng.optimize_parameters(data, epoch=i - 1, **kw)
        losses.append(dict(eng.loss_info["latest"]))
        moments.append(first_moments(eng))
    return losses, moments


def check_against(name, eng, got, want, want_losses, stored, steps=(1, 2)) -> dict:
    """The port's run of ``steps`` (``run_port``'s ``got``) against the
    golden case ``want``; returns what the checks read.

    The loss terms: fp32 1e-4 relative, bf16 ``TOL_BF16``.

    With step 1, Adam's first moment after it (0.1 x the gradient plus
    weight decay), by ``parity.check_grads``. fp32: each leaf within
    ``GRAD_TOL`` of its own largest magnitude; the score heads'
    ``logit_scale`` and ``score_bias``, sums over every pixel, prompt and
    image, within ``REDUCTION_TOL`` of theirs (read up to 8.5e-4); a leaf
    whose gradient cancels to zero in exact arithmetic (at nf 8 a bias ahead
    of a one-channel GroupNorm group, a key bias in the softmax) within
    ``GRAD_FLOOR`` of the net's largest other leaf, its roundoff (up to 29 of
    288 leaves, read up to 2.0e-6). bf16: a gradient is rounded in dozens of
    bf16 ops on either side; JAX's own bf16 step is a median 2% per leaf
    from its fp32 step, and up to 86 times the leaf's scale where the
    gradient cancels, so no per-leaf bf16 bound would hold JAX to itself.
    Each leaf is held within ``TOL_BF16`` of the net's largest leaf beyond
    the distance between JAX's bf16 and fp32 steps on that leaf (the fp32
    case of the same state, ``FP32_CASE``; read up to 7.9e-3). The noise
    net's ``logit_scale`` is 1.2e-2 from JAX's bf16 step, which is itself
    1.2e-2 from the fp32 step; the port's is 3.4e-4 from it.
    ``tools/train_parity_report.py`` prints these readings.

    The parameters after the last step: within ``tol`` (fp32 1e-5, bf16
    ``TOL_BF16``) of each leaf's largest magnitude, and at most
    ``ADAM_CAP`` elements per net beyond that but within what Adam makes
    of their gradient's tolerance (``parity.check_params``; read up to 11
    in fp32, 34 in bf16): elements whose gradient lies within roundoff of
    zero, whose step's size and sign are roundoff's."""
    kind, dtype, _ = golden.CASES[name]
    fp32 = dtype == "float32"
    tol = 1e-5 if fp32 else TOL_BF16
    grad_tol = (GRAD_TOL, GRAD_FLOOR, REDUCTION_TOL) if fp32 else (0.0, TOL_BF16, 0.0)
    losses, moments = got
    for got_l, want_l in zip(losses, want_losses):
        assert sorted(got_l) == sorted(want_l)
        for k in want_l:
            assert got_l[k] == pytest.approx(want_l[k], rel=1e-4 if fp32 else TOL_BF16,
                                             abs=1e-6 if fp32 else TOL_BF16), (name, k)
    keep = (lambda t: t) if name in golden.FULL else golden.subset
    lrs = [cosine_annealing_lr(i - 1, golden.NEPOCH, 1e-3, golden.COMMON["eta_min"])
           for i in steps]
    read = {}
    for key in golden.trained_keys(kind):
        if steps[0] == 1:
            want_m, slack = _flat(want["mu1"][key]), None
            if not fp32:  # JAX's own bf16 step against its fp32 step, per leaf
                ref = _flat(golden.subset(stored[0][FP32_CASE[name]]["mu1"][key]))
                slack = {k: float(np.abs(v - ref[k]).max()) for k, v in want_m.items()}
            _, read[key + " first moment"] = check_grads(
                _flat(keep(moments[1][key])), want_m, *grad_tol, slack=slack,
                what=f"{name} {key} mu1 ")
        # the gradient plus decay Adam saw at each step, from its moments
        m = [_flat(keep(moments[i][key])) for i in range(len(moments))]
        grads = [{k: (m[i + 1][k] - 0.9 * m[i][k]) / 0.1 for k in m[i + 1]}
                 for i in range(len(steps))]
        read[key + " parameters"] = check_params(
            _flat(keep(flax_params(eng.nets[key]))), _flat(want["params"][key]), tol,
            [(lr, g, grad_tolerances(g, *grad_tol)) for lr, g in zip(lrs, grads)],
            ADAM_CAP[dtype], what=f"{name} {key} ")
    return read


@pytest.mark.parametrize("name", list(golden.CASES))
def test_train_step_matches_jax_golden(name, stored):
    """Two port train steps from the golden's seeded state with JAX's draws:
    the loss terms of both steps and the trained parameters after step 2."""
    arrays, losses = stored
    eng = port_engine(name)
    check_against(name, eng, run_port(eng, arrays[name]), arrays[name], losses[name], stored)
    for p in eng.nets.parameters():  # fp32 master weights, bf16 too
        assert p.dtype == torch.float32
    for opt in eng.optimizers.values():
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def _resume_dir(tmp_path, eng):
    """The golden's JAX-written bundle and state after step 1, with the
    text tower's sidecar the port writes for the seeded tower."""
    src = os.path.join(GOLDEN, "resume")
    for f in os.listdir(src):
        os.symlink(os.path.join(src, f), tmp_path / f)
    ckpt.save_pytree(flax_params(eng.text_encoder), str(tmp_path / TEXT_SIDECAR))
    return str(tmp_path)


def test_jax_training_state_resumes_in_port(stored, tmp_path):
    """JAX's bundle and ``{iter}.state`` after step 1, loaded as ``trainUM``
    resumes: the port's step 2 gives JAX's step-2 losses and parameters."""
    arrays, losses = stored
    name = golden.RESUME_CASE
    eng = port_engine(name)
    d = _resume_dir(tmp_path, eng)
    epoch, it = eng.resume_training(os.path.join(d, f"{golden.RESUME_ITER}.state"))
    assert (epoch, it, eng.step, eng.ema_restored) == (0, golden.RESUME_ITER, 1, True)
    eng.load(d, golden.RESUME_ITER, load_ema=False)
    got = run_port(eng, arrays[name], steps=(2,))
    check_against(name, eng, got, arrays[name], losses[name][1:], stored, steps=(2,))


def test_port_resaves_jax_training_state_byte_for_byte(tmp_path):
    eng = port_engine(golden.RESUME_CASE)
    path = os.path.join(GOLDEN, "resume", f"{golden.RESUME_ITER}.state")
    epoch, it = eng.resume_training(path)
    eng.save_training_state(str(tmp_path), epoch, it)
    with open(path, "rb") as f, open(tmp_path / os.path.basename(path), "rb") as g:
        assert f.read() == g.read()


def test_state_without_ema_falls_back(tmp_path):
    """A state JAX wrote without the EMA shadows (``save_training_state``
    with the optimizers and the step only): the optimizers and step are
    restored and ``ema_restored`` is False, so ``load`` reads the rolling
    EMA files, as JAX's ``resume_training`` falls back."""
    eng = port_engine(golden.RESUME_CASE)
    ema_before = flax_params(eng.nets["d_ema"])
    trees = {k: jax.tree.map(jnp.asarray, flax_params(eng.nets[k])) for k in ("drift", "noise")}
    _, init = jax_adam()
    opt = {"d_opt": init(trees["drift"]), "n_opt": init(trees["noise"]),
           "step": jnp.asarray(7, jnp.int32)}
    jax_ckpt.save_training_state(str(tmp_path), 7, 2, opt)
    epoch, it = eng.resume_training(str(tmp_path / "7.state"))
    assert (epoch, it, eng.step, eng.ema_restored) == (2, 7, 7, False)
    _assert_trees_close(flax_params(eng.nets["d_ema"]), ema_before, 0.0)
    eng.save_training_state(str(tmp_path / "port"), epoch, it)
    assert "d_ema" in ckpt.load_training_state(str(tmp_path / "port" / "7.state"))["opt"]


@functools.lru_cache(maxsize=None)
def jax_adam():
    """The JAX engines' optimizer at the golden's settings, and its jitted
    init (one compile for the module's tests)."""
    tx = jax_drift.make_adam(1e-3, 0.9, 0.99, 1e-4)
    return tx, jax.jit(tx.init)


def test_jax_training_state_maps_onto_the_port_and_back():
    """A JAX engine's whole ``state`` (nets, EMA shadows, optax states with
    seeded moments and counts, step) through ``load_engine`` into the port
    and back out by ``engine_state``: every leaf equal."""
    eng = port_engine(golden.RESUME_CASE)
    rng = _rng(6)
    tx, init = jax_adam()

    def seeded(key):
        return jax.tree.map(jnp.asarray, golden.seeded_tree(flax_params(eng.nets[key]), rng))

    state = {"step": jnp.asarray(5, jnp.int32)}
    for key in ("drift", "noise", "d_ema", "n_ema"):
        state[key] = seeded(key)
    for key in ("drift", "noise"):
        empty = init(state[key])
        count = jnp.asarray(5, jnp.int32)
        moments = empty.inner_state[1]._replace(
            count=count, mu=seeded(key), nu=jax.tree.map(jnp.abs, seeded(key)))
        state[key[0] + "_opt"] = empty._replace(count=count, inner_state=(
            empty.inner_state[0], moments, empty.inner_state[2]))
    load_engine(eng, state)
    back = engine_state(eng)
    want = {k: jax.tree.map(np.asarray, flax_state_dict(v)) for k, v in state.items()}
    assert sorted(back) == sorted(want) and eng.step == 5
    for key in ("drift", "noise", "d_ema", "n_ema"):
        _assert_trees_close(back[key], want[key], 0.0, key)
    for key in ("d_opt", "n_opt"):
        assert int(back[key]["count"]) == int(want[key]["count"]) == 5
        assert float(back[key]["hyperparams"]["learning_rate"]) == pytest.approx(1e-3)
        for m in ("mu", "nu"):
            _assert_trees_close(back[key]["inner_state"]["1"][m],
                                want[key]["inner_state"]["1"][m], 0.0, f"{key} {m}")


# ---------------------------------------------------------------- the repairs


def test_acc_drift_builds_trains_and_refuses_to_sample():
    eng = port_engine("drift_fp32_acc_drift")
    data = golden.batch()
    loss = eng.optimize_parameters(data, torch.Generator().manual_seed(0))
    assert np.isfinite(loss)
    with pytest.raises(ValueError, match="unavailable at sampling time"):
        eng.test(data)


def test_train_step_launches_no_kernel_wrapper(monkeypatch):
    """Every kernel wrapper the UNet calls patched to raise: a train step
    (drift, bf16, remat on) still runs, so no train path reaches a CUDA
    kernel."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called in a train step")

    for name in ("fused_gn_silu_conv3x3", "gn_channel_affine", "group_norm_silu",
                 "flash_attention"):
        monkeypatch.setattr(unet_mod, name, refuse)
    eng = port_engine("drift_bf16")
    for key in ("drift", "noise"):
        eng.nets[key].remat = True
    assert np.isfinite(eng.optimize_parameters(golden.batch(), torch.Generator().manual_seed(1)))
    with pytest.raises(AssertionError, match="kernel wrapper"):
        eng.test(golden.batch(), sample_steps=1)


def test_remat_changes_no_gradient():
    """The ResBlocks rematerialised in the backward give the same update."""
    a, b = port_engine("drift_fp32"), port_engine("drift_fp32")
    for key in ("drift", "noise"):
        a.nets[key].remat = True
    for eng in (a, b):
        eng.optimize_parameters(golden.batch(), torch.Generator().manual_seed(2))
    for key in ("drift", "noise"):
        for p, q in zip(a.nets[key].parameters(), b.nets[key].parameters()):
            assert torch.equal(p, q)


# ---------------------------------------------------------------- live JAX


@pytest.mark.slow
@pytest.mark.parametrize("name", list(golden.CASES))
def test_train_step_matches_jax_live_and_golden_is_current(name, stored):
    """JAX's jitted train step run now: its draws, losses and parameters equal
    the stored golden's, and the port matches them."""
    arrays, losses = stored
    live = golden.run_case(name)
    np.testing.assert_array_equal(live["t"], arrays[name]["t"])
    np.testing.assert_array_equal(live["std_noise"], arrays[name]["std_noise"])
    if "deg_noise" in live:
        np.testing.assert_array_equal(live["deg_noise"], arrays[name]["deg_noise"])
    assert live["losses"] == losses[name]
    for part in ("params", "mu1"):
        for key, tree in live[part].items():
            _assert_trees_close(tree, arrays[name][part][key], 0.0, f"{name} {key} ")
    eng = port_engine(name)
    check_against(name, eng, run_port(eng, live), live, live["losses"], stored)
