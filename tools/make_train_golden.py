"""Write the train-step golden of the PyTorch port: JAX's jitted train step
(``build_train_step`` through ``optimize_parameters``) at
``Configurations/tiny_cpu.yml``'s widths, two steps per case from one seeded
state, into ``tests/data_torch/train_golden/``.

    JAX_PLATFORMS=cpu python tools/make_train_golden.py

Each case (``CASES``) builds the JAX engine with every parameter leaf drawn
from a numpy seed (``seeded_tree``, in sorted-key order, so the port draws the
same values from its own trees), runs two steps at epochs 0 and 1 (the cosine
learning rate changes between them) on one batch, and keeps what the port
needs to repeat them without JAX: each step's timesteps and standard noise,
and with ``degrade_on_device`` the degradation's five noises, as the step
draws them from its key; the loss terms of both steps; the trained nets'
parameters after step 2 (fp32) and Adam's first moment after step 1 (0.1 x
the gradient plus weight decay: the backward's result), all of them for the
cases in ``FULL`` and the leaves under ``SUBSET`` for the others. For
``RESUME_CASE`` it also keeps the bundle and the training state JAX wrote
after step 1 (``resume/``).

Files: ``golden.ckpt`` (flax msgpack: per case ``t`` [2,B], ``std_noise``
[2,B,H,W,1], ``deg_noise`` [2,5,B,H,W,1], ``params`` and ``mu1`` {net: tree}),
``losses.json`` (per case and step the loss terms) and ``resume/``.
``tests/test_torch_train.py`` holds the port to them; its slow test runs
this script's cases live and checks that the stored golden is current."""

from __future__ import annotations

import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "data_torch", "train_golden")
SEED, RES, B, T, NEPOCH = 0, 32, 2, 8, 4
# Configurations/tiny_cpu.yml's nets, optimizer and SDE
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], num_res_blocks=1, context_dim=16,
                text_module="scoremap", score_map_chan=4, if_MultiScoreMap=True)
COMMON = dict(use_image_context=True, CLIP_Type="CLIP", tiny_text_encoder=True,
              beta1=0.9, beta2=0.99, nepoch=NEPOCH, eta_min=1e-6, image_size=RES)
DRIFT = dict(score_map_ch_mult=(1, 1), score_map_ngf=8, drift_net_lr=1e-3, noise_net_lr=1e-3,
             weight_decay_drift=1e-4)
DDPM = dict(noise_net_lr=1e-3, weight_decay=1e-4)
MAX_SIGMA = {"drift": 0.4, "ddpm": 1.0}
# name: (engine, dtype, engine keyword arguments)
CASES = {
    "drift_fp32": ("drift", "float32", {}),
    "drift_bf16": ("drift", "bfloat16", {}),
    "ddpm_fp32_degrade": ("ddpm", "float32", {"degrade_on_device": True}),
    "drift_fp32_acc_drift": ("drift", "float32",
                             {"optimize_type": "predict_std_noise_acc_drift"}),
    "drift_fp32_scale_drift": ("drift", "float32",
                               {"optimize_type": "predict_std_noise_scale_drift"}),
    "drift_fp32_x0": ("drift", "float32", {"optimize_type": "predict_x0"}),
    "drift_fp32_degrade": ("drift", "float32", {"degrade_on_device": True}),
    "drift_fp32_degra_ctx_l1_uni": ("drift", "float32", {"use_degra_context": True,
                                                         "drift_loss": "l1",
                                                         "noise_loss": "uni"}),
}
FULL = ("drift_fp32", "ddpm_fp32_degrade")
# the leaves kept for the other cases: every leaf under these top-level modules
SUBSET = ("conv_in", "enc_0_0", "mid_attn", "smm_0", "dec_0_0", "conv_out")
RESUME_CASE, RESUME_ITER = "drift_fp32", 1


def trained_keys(kind: str) -> tuple:
    return ("drift", "noise") if kind == "drift" else ("noise",)


def seeded_tree(tree, rng) -> dict:
    """A flax tree of the same paths and shapes as ``tree``, each leaf drawn
    from ``rng`` in sorted-key order: kernels ~ N(0, 1/fan_in), embeddings ~
    N(0, 1), norm scales ~ 1 + 0.1 N, everything else ~ 0.1 N (no branch
    stays at a zero init)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
            continue
        shape = tuple(v.shape)
        r = rng.standard_normal(shape)
        if k == "kernel":
            r = r / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            r = 1 + 0.1 * r
        elif k != "embedding":
            r = 0.1 * r
        out[k] = np.asarray(r, dtype=np.float32)
    return out


def seeded_state(templates: dict, seed: int = SEED) -> dict:
    """The case's starting weights from ``seed``: ``templates`` (flax trees
    of the trained nets, then ``"text"`` for the tower) each redrawn by
    ``seeded_tree`` in the order given, from one generator."""
    rng = np.random.default_rng(seed)
    return {k: seeded_tree(v, rng) for k, v in templates.items()}


def batch(seed: int = SEED + 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"input": rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
            "target": rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
            "type_idx": np.array([0, 3], np.int32),
            "A_emb": rng.standard_normal((B, 1, SETTINGS["context_dim"])).astype(np.float32)}


def subset(tree: dict) -> dict:
    """The leaves of a net's flax tree that a non-FULL case keeps."""
    inner = tree["params"] if "params" in tree else tree
    return {"params": {k: v for k, v in inner.items() if k in SUBSET}}


# ---------------------------------------------------------------- JAX side


@contextlib.contextmanager
def shapes_only_init():
    """The JAX engines' jitted net init traced for shapes only (every leaf is
    redrawn from the seed afterwards; the two compiles cost ~20 s)."""
    import jax
    import jax.numpy as jnp

    real_jit = jax.jit

    def jit(fun, *args, **kwargs):
        if "init_net" not in getattr(fun, "__qualname__", ""):
            return real_jit(fun, *args, **kwargs)

        def shapes(*a):
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(fun, *a))
        return shapes

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real_jit


def jax_engine(name: str):
    """The case's JAX engine (``if_train``), its nets and tower seeded."""
    import jax
    import jax.numpy as jnp

    from instancediff_tpu.models.ddpm_model import CLIPDDPMEngine
    from instancediff_tpu.models.drift_model import CLIPDriftEngine
    from instancediff_tpu.sde import DDPMSDE, DriftSDE

    kind, dtype, kw = CASES[name]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with shapes_only_init():
        if kind == "drift":
            eng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=MAX_SIGMA[kind]),
                                  dtype=jdt, seed=SEED, **COMMON, **DRIFT, **kw)
        else:
            eng = CLIPDDPMEngine(SETTINGS, sde=DDPMSDE(T=T, max_sigma=MAX_SIGMA[kind]),
                                 dtype=jdt, seed=SEED, **COMMON, **DDPM, **kw)
    keys = trained_keys(kind)
    state = seeded_state({**{k: eng.state[k] for k in keys}, "text": eng.text_params})
    eng.text_params = state.pop("text")
    for k in keys:
        eng.state[k] = jax.tree.map(jnp.asarray, state[k])
        eng.state[k[0] + "_ema"] = jax.tree.map(jnp.asarray, state[k])
        opt = eng.drift_opt if k == "drift" else (eng.noise_opt if kind == "drift" else eng.opt)
        eng.state[k[0] + "_opt"] = opt.init(eng.state[k])
    return eng


def step_key(i: int):
    import jax

    return jax.random.fold_in(jax.random.key(SEED), i)


def draws(name: str, key) -> dict:
    """The step's random draws from its key, as the jitted step makes them:
    with ``degrade_on_device`` first ``key, k_deg = split(key)`` and the five
    degradation noises from ``split(k_deg, 5)``; then ``forward_diffusion``'s
    ``kt, kn = split(key)``: t ~ U{1..T} from kt, the standard noise from
    kn."""
    import jax

    kind, _, kw = CASES[name]
    out = {}
    shape = (B, RES, RES, 1)
    if kw.get("degrade_on_device"):
        key, k_deg = jax.random.split(key)
        out["deg_noise"] = np.stack([np.asarray(jax.random.normal(k, shape))
                                     for k in jax.random.split(k_deg, 5)])
    kt, kn = jax.random.split(key)
    out["t"] = np.asarray(jax.random.randint(kt, (B,), 1, T + 1), np.int32)
    out["std_noise"] = np.asarray(jax.random.normal(kn, shape))
    return out


def run_case(name: str, resume_dir=None) -> dict:
    """Two JAX train steps of the case: its draws, loss terms, (FULL, or
    ``subset``) trained parameters after step 2 and first moments after
    step 1; with ``resume_dir`` the bundle and training state after step 1
    are written there."""
    import jax
    import jax.numpy as jnp
    from flax.serialization import to_state_dict

    eng = jax_engine(name)
    keep = (lambda t: t) if name in FULL else subset
    keys = trained_keys(CASES[name][0])
    data = {k: jnp.asarray(v) for k, v in batch().items()}
    steps = []
    for i in (1, 2):
        key = step_key(i)
        steps.append(draws(name, key))
        eng.optimize_parameters(data, key, epoch=i - 1)
        steps[-1]["losses"] = dict(eng.loss_info["latest"])
        if i == 1:
            mu1 = {k: keep(jax.tree.map(np.asarray, to_state_dict(
                eng.state[k[0] + "_opt"])["inner_state"]["1"]["mu"])) for k in keys}
        if resume_dir is not None and i == RESUME_ITER:
            eng.save(resume_dir, RESUME_ITER)
            eng.save_training_state(resume_dir, i - 1, RESUME_ITER)
            for f in os.listdir(resume_dir):  # the state carries the EMA
                if f.startswith("lastest_"):
                    os.remove(os.path.join(resume_dir, f))
    params = {k: keep(jax.tree.map(np.asarray, eng.state[k])) for k in keys}
    out = {"t": np.stack([s["t"] for s in steps]),
           "std_noise": np.stack([s["std_noise"] for s in steps]), "params": params,
           "mu1": mu1, "losses": [s["losses"] for s in steps]}
    if "deg_noise" in steps[0]:
        out["deg_noise"] = np.stack([s["deg_noise"] for s in steps])
    return out


def write(out_dir: str = OUT) -> None:
    from instancediff_tpu.utils.checkpoint import save_pytree

    os.makedirs(os.path.join(out_dir, "resume"), exist_ok=True)
    arrays, losses = {}, {}
    for name in CASES:
        res = run_case(name, os.path.join(out_dir, "resume") if name == RESUME_CASE else None)
        losses[name] = res.pop("losses")
        arrays[name] = res
        print(name, losses[name], flush=True)
    save_pytree(arrays, os.path.join(out_dir, "golden.ckpt"))
    with open(os.path.join(out_dir, "losses.json"), "w") as f:
        json.dump(losses, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write()
