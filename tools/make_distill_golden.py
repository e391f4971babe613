"""Write the distillation-step golden of the PyTorch port: JAX's jitted
``build_distill_step`` at ``Configurations/tiny_cpu.yml``'s widths, two
steps per case from one seeded state, into
``tests/data_torch/distill_golden/``.

    JAX_PLATFORMS=cpu python tools/make_distill_golden.py

Each case (``CASES``: dtype, the teacher's eta, ``z1_correction``) builds
the JAX drift engine of ``tools/make_train_golden.py`` with every leaf drawn
from a numpy seed (``make_train_golden.seeded_state``: the student's drift
and noise nets, the text tower, then the teacher's two nets, from one
generator, so the student and the teacher differ), and runs two distill
steps of the student at N = ``STUDENT_STEPS`` on one batch at the phase's
cosine learning rate (``LR`` annealed over two steps). It keeps what the
port needs to repeat them without JAX: each step's draws as the step makes
them from its key (the pair index per sample, the marginal's noise and the
teacher's first-step noise), the teacher's composed targets (read where the
step stops their gradient), the loss terms, Adam's first moment after step
1 and the parameters after step 2 (every leaf for ``FULL``, the leaves under
``make_train_golden.SUBSET`` for the other cases).

Files: ``golden.ckpt`` (flax msgpack: per case ``pair`` [2,B], ``eps`` and
``z1`` [2,B,H,W,1], ``d_tgt`` and ``n_tgt`` [2,B,H,W,1], ``params`` and
``mu1`` {net: tree}) and ``losses.json``. ``tests/test_torch_distill.py``
holds the port to them; its slow test runs these cases live and checks that
the stored golden is current."""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import make_train_golden as train_golden  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data_torch", "distill_golden")
STUDENT_STEPS, LR = 4, 1e-3
# name: (dtype, teacher_eta, z1_correction)
CASES = {
    "fp32_eta0": ("float32", 0.0, False),
    "fp32_eta1": ("float32", 1.0, False),
    "fp32_eta1_z1": ("float32", 1.0, True),
    "bf16_eta0": ("bfloat16", 0.0, False),
}
FULL = ("fp32_eta0",)
# the templates of the seeded state, in draw order
DRAW_ORDER = ("drift", "noise", "text", "teacher_drift", "teacher_noise")


def lr_at(step: int) -> float:
    """The phase's cosine learning rate at 1-based ``step`` of 2."""
    return float(LR * 0.01 + (LR - LR * 0.01) * (1 + np.cos(np.pi * (step - 1) / 2)) / 2.0)


def templates(nets: dict, text) -> dict:
    """The seeded state's templates in ``DRAW_ORDER`` from the student's two
    net trees and the tower's."""
    return {"drift": nets["drift"], "noise": nets["noise"], "text": text,
            "teacher_drift": nets["drift"], "teacher_noise": nets["noise"]}


def jax_engine(name: str):
    """The case's JAX engine (student, tower) and its seeded teacher."""
    import jax
    import jax.numpy as jnp

    from instancediff_tpu.models.drift_model import CLIPDriftEngine
    from instancediff_tpu.sde import DriftSDE

    dtype, _, _ = CASES[name]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with train_golden.shapes_only_init():
        eng = CLIPDriftEngine(train_golden.SETTINGS, train_golden.SETTINGS,
                              sde=DriftSDE(T=train_golden.T, max_sigma=0.4), dtype=jdt,
                              seed=train_golden.SEED, **train_golden.COMMON,
                              **train_golden.DRIFT)
    state = train_golden.seeded_state(templates(eng.state, eng.text_params))
    eng.text_params = state["text"]
    for k in ("drift", "noise"):
        eng.state[k] = jax.tree.map(jnp.asarray, state[k])
        eng.state[k[0] + "_ema"] = jax.tree.map(jnp.asarray, state[k])
        opt = eng.drift_opt if k == "drift" else eng.noise_opt
        eng.state[k[0] + "_opt"] = opt.init(eng.state[k])
    teacher = {k: jax.tree.map(jnp.asarray, state["teacher_" + k]) for k in ("drift", "noise")}
    return eng, teacher


def step_key(i: int):
    import jax

    return jax.random.fold_in(jax.random.key(train_golden.SEED + 7), i)


def draws(name: str, key) -> dict:
    """The step's draws from its key, as the jitted step makes them:
    ``k_i, k_e, k_z1 = split(key, 3)``; the pair index per sample from k_i,
    the marginal's noise from k_e, the teacher's first-step noise from k_z1
    (zeros at eta 0)."""
    import jax

    _, eta, _ = CASES[name]
    shape = (train_golden.B, train_golden.RES, train_golden.RES, 1)
    k_i, k_e, k_z1 = jax.random.split(key, 3)
    return {"pair": np.asarray(jax.random.randint(k_i, (train_golden.B,), 0, STUDENT_STEPS),
                               np.int32),
            "eps": np.asarray(jax.random.normal(k_e, shape)),
            "z1": np.asarray(jax.random.normal(k_z1, shape)) if eta else np.zeros(
                shape, np.float32)}


@contextlib.contextmanager
def captured_targets(out: list):
    """While open, every ``jax.lax.stop_gradient`` call (in the distill step
    only its two composed targets) also passes its value to ``out``, in
    order, from inside the jitted step."""
    import jax

    real = jax.lax.stop_gradient

    def stop_gradient(x):
        jax.debug.callback(lambda v: out.append(np.asarray(v)), x, ordered=True)
        return real(x)

    jax.lax.stop_gradient = stop_gradient
    try:
        yield
    finally:
        jax.lax.stop_gradient = real


def run_case(name: str) -> dict:
    """Two JAX distill steps of the case: its draws, targets, loss terms,
    (FULL, or ``subset``) parameters after step 2 and first moments after
    step 1."""
    import jax
    import jax.numpy as jnp
    from flax.serialization import to_state_dict

    from instancediff_tpu.models.distill import build_distill_step

    _, eta, z1c = CASES[name]
    eng, teacher = jax_engine(name)
    keep = (lambda t: t) if name in FULL else train_golden.subset
    data = {k: jnp.asarray(v) for k, v in train_golden.batch().items()}
    got = []
    with captured_targets(got):
        step = jax.jit(build_distill_step(eng, STUDENT_STEPS, teacher_eta=eta,
                                          z1_correction=z1c))
        state = eng.state
        steps = []
        for i in (1, 2):
            key = step_key(i)
            steps.append(draws(name, key))
            lr = jnp.asarray(lr_at(i), jnp.float32)
            state, metrics = step(state, data, key, teacher, eng.text_params, lr, lr)
            jax.effects_barrier()
            steps[-1]["losses"] = {k: float(v) for k, v in metrics.items()}
            if i == 1:
                mu1 = {k: keep(jax.tree.map(np.asarray, to_state_dict(
                    state[k[0] + "_opt"])["inner_state"]["1"]["mu"])) for k in ("drift", "noise")}
    assert len(got) == 4, f"expected 2 targets per step, got {len(got)}"
    params = {k: keep(jax.tree.map(np.asarray, state[k])) for k in ("drift", "noise")}
    return {**{k: np.stack([s[k] for s in steps]) for k in ("pair", "eps", "z1")},
            "d_tgt": np.stack(got[0::2]).astype(np.float32),
            "n_tgt": np.stack(got[1::2]).astype(np.float32),
            "params": params, "mu1": mu1, "losses": [s["losses"] for s in steps]}


def write(out_dir: str = OUT) -> None:
    from instancediff_tpu.utils.checkpoint import save_pytree

    os.makedirs(out_dir, exist_ok=True)
    arrays, losses = {}, {}
    for name in CASES:
        res = run_case(name)
        losses[name] = res.pop("losses")
        arrays[name] = res
        print(name, losses[name], flush=True)
    save_pytree(arrays, os.path.join(out_dir, "golden.ckpt"))
    with open(os.path.join(out_dir, "losses.json"), "w") as f:
        json.dump(losses, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write()
