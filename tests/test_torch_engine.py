"""Parity of the PyTorch port (``instancediff_torch``) with the JAX engine on
the CPU, at a tiny size: nf 8, ch_mult (1, 2), one ResBlock per level, 16 px,
the tiny text tower, float32.

Every JAX parameter leaf is randomised with numpy before it is converted
(``conv2``, ``conv_out`` and the attention ``out`` projections start at zero,
which would hide whole branches), and both sides get the same inputs and,
for the sampler, the same noise: JAX's own draws are fed to the port."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.models.drift_model import CLIPDriftEngine as JaxEngine
from instancediff_tpu.sde import DriftSDE as JaxSDE
from instancediff_tpu.sde.schedules import make_schedule as jax_make_schedule
from instancediff_tpu.sde.schedules import strided_sampling_grid as jax_grid

from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.scoremap import ScoreMapModule
from instancediff_torch.models.text_encoder import build_text_encoder
from instancediff_torch.models.unet import LearnableForwardUNetMultiScoreMap
from instancediff_torch.sde import DriftSDE
from instancediff_torch.sde.schedules import make_schedule, strided_sampling_grid
from instancediff_torch.serving import Restorer
from instancediff_torch.utils.convert import load_engine, load_flax_params

RES, B, T = 16, 2, 4
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16,
                text_module="scoremap", score_map_chan=4, if_MultiScoreMap=True,
                num_res_blocks=1)
ENGINE_KW = dict(score_map_ch_mult=(1, 1), score_map_ngf=8, use_image_context=True,
                 CLIP_Type="CLIP", tiny_text_encoder=True)


def randomize(tree, rng):
    """Every leaf redrawn: kernels ~ N(0, 1/fan_in), norm scales ~ 1 +
    0.1 N, biases and free parameters ~ 0.1 N (plus their init)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        a = np.asarray(v, dtype=np.float32)
        if k == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            r = rng.standard_normal(a.shape) / np.sqrt(fan_in)
        elif k == "embedding":
            r = rng.standard_normal(a.shape)
        elif k == "scale":
            r = 1.0 + 0.1 * rng.standard_normal(a.shape)
        else:
            r = a + 0.1 * rng.standard_normal(a.shape)
        out[k] = r.astype(np.float32)
    return out


@contextlib.contextmanager
def jits_shapes_only(match: str):
    """While open, each ``jax.jit`` of a function whose qualified name holds
    ``match`` is traced for shapes only (``jax.eval_shape``, zeros) instead
    of compiled: the tests overwrite every leaf from a numpy seed. One
    function's nets of one configuration (the drift and noise nets of most
    engines) are traced once. Every other ``jax.jit`` is JAX's own."""
    real_jit = jax.jit
    traced = {}

    def jit(fun, *args, **kwargs):
        name = getattr(fun, "__qualname__", "")
        if match not in name:
            return real_jit(fun, *args, **kwargs)
        free = dict(zip(fun.__code__.co_freevars, (c.cell_contents for c in fun.__closure__ or ())))
        net = repr(free.get("net"))

        def shapes(*a):
            key = (fun.__code__, net, tuple((x.shape, x.dtype) for x in jax.tree.leaves(a)))
            if key not in traced:
                traced[key] = jax.eval_shape(fun, *a)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), traced[key])
        return shapes

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", jit)
        yield


def shapes_only_init():
    """JAX's engines' jitted net inits (``init_net``) for shapes only: the two
    compiles cost about 20 s on the CPU."""
    return jits_shapes_only("init_net")


def inits_shapes_only(engine_class: str):
    """The jitted inits in ``<engine_class>.__init__`` (the text tower's and
    the nets') for shapes only."""
    return jits_shapes_only(f"{engine_class}.__init__")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny nets of the port's parity tests run faster on one thread,
    and much faster when the test workers share the machine's cores (torch's
    worker threads then wait on each other); restored afterwards. The files
    that share this module's helpers import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_engine():
    """The tiny JAX engine with every parameter leaf randomised."""
    with inits_shapes_only("CLIPDriftEngine"):
        eng = JaxEngine(dnet_settings=SETTINGS, nnet_settings=SETTINGS,
                        sde=JaxSDE(T=T, max_sigma=0.4), if_train=False, image_size=RES,
                        **ENGINE_KW)
    rng = np.random.default_rng(0)
    for key in ("drift", "noise", "d_ema", "n_ema"):
        eng.state[key] = randomize(eng.state[key], rng)
    eng.text_params = randomize(eng.text_params, rng)
    return eng


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    eng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=0.4),
                          device="cpu", **ENGINE_KW)
    return load_engine(eng, jax_engine.state, jax_engine.text_params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return dict(
        x_a=rng.standard_normal((B, RES, RES, 1)).astype(np.float32),
        x_b=rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
        t=np.array([3, 1], np.int32),
        type_idx=np.array([4, 1], np.int32),
        emb=rng.standard_normal((B, 1, SETTINGS["context_dim"])).astype(np.float32),
    )


def _jax_text(eng, params):
    text_fn = eng._make_text_fn(eng.text_params)
    return [np.asarray(text_fn(c)) for c in eng._smm_contexts(params)]


def test_schedules_and_grid_equal_jax():
    for name in ("linear", "cosine", "sigmoid", "constant"):
        np.testing.assert_array_equal(make_schedule(name, 100).numpy(),
                                      np.asarray(jax_make_schedule(name, 100)))
    for steps in (None, 2, 7, 100):
        hi, lo = strided_sampling_grid(100, steps)
        jhi, jlo = jax_grid(100, steps)
        assert hi == list(np.asarray(jhi)) and lo == list(np.asarray(jlo))
    sde, jsde = DriftSDE(T=100), JaxSDE(T=100)
    np.testing.assert_array_equal(sde.sigmas.numpy(), np.asarray(jsde.sigmas))


def test_tokenizer_ids_equal_engine_prompt_ids(jax_engine, port_engine):
    np.testing.assert_array_equal(port_engine.prompt_ids.numpy(),
                                  np.asarray(jax_engine.prompt_ids))


def test_text_tower_with_spliced_context(jax_engine, port_engine):
    ctx = np.random.default_rng(2).standard_normal((8, 48)).astype(np.float32)
    want = np.asarray(jax_engine.text_encoder.apply(
        jax_engine.text_params, jax_engine.prompt_ids, jnp.asarray(ctx)))
    with torch.no_grad():
        got = port_engine.text_encoder(port_engine.prompt_ids, torch.from_numpy(ctx))
    # float32 on both sides; differences are summation order only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_full_size_text_tower_shapes():
    enc, token_dim = build_text_encoder(512)
    assert token_dim == 512 and enc.layers == 12 and enc.context_length == 42
    assert enc.token_embedding.weight.shape == (49408, 512)


@pytest.mark.parametrize("hw", [8, 32])
def test_scoremap_module(hw):
    """Unpooled (8x8) and pooled (32x32 -> 16x16 memory) score maps."""
    from instancediff_tpu.models.scoremap import ScoreMapModule as JaxSMM

    rng = np.random.default_rng(hw)
    vis = rng.standard_normal((2, hw, hw, 12)).astype(np.float32)
    text = rng.standard_normal((5, 16)).astype(np.float32)
    jsmm = JaxSMM(visual_dim=8, token_embed_dim=24, embed_dim=16)
    # jitted: one compiled program instead of each op compiled eagerly
    params = randomize(jax.jit(jsmm.init)(jax.random.key(0), vis, text), rng)
    want = np.asarray(jax.jit(jsmm.apply)(params, vis, text))
    smm = load_flax_params(ScoreMapModule(12, 8, token_embed_dim=24, embed_dim=16), params)
    with torch.no_grad():
        got = smm(torch.from_numpy(vis), torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_net", "fused_flash_clone"])
def test_unet_forward(jax_engine, port_engine, inputs, fused):
    """Prediction and every score map against the JAX UNet, both as built
    and as the sampler's ``use_fused_gnconv=True, flash_mid=True`` clone
    (on the CPU: the fused conv's jnp reference, flash in interpret mode)."""
    net = jax_engine.drift_net
    if fused:
        net = net.clone(use_fused_gnconv=True, flash_mid=True)
    params = jax_engine.state["d_ema"]
    text = _jax_text(jax_engine, params)
    i = inputs
    want_pred, want_maps = jax.jit(lambda p, *a: net.apply(
        p, *a[:4], text_embs=a[4], image_context=a[5]))(
            params, i["x_a"], i["x_b"], i["t"], i["type_idx"], text, i["emb"])
    with torch.no_grad():
        pred, maps = port_engine.nets["d_ema"](
            torch.from_numpy(i["x_a"]), torch.from_numpy(i["x_b"]),
            torch.from_numpy(i["t"]), torch.from_numpy(i["type_idx"]),
            [torch.tensor(t) for t in text], torch.from_numpy(i["emb"]))
    assert pred.shape == (B, RES, RES, 1) and len(maps) == len(want_maps) == 2
    # float32; ~20 chained convs with random weights: summation order only
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-4, atol=1e-4)
    for got, want in zip(maps, want_maps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_converter_rejects_leftover_and_missing_leaves(jax_engine):
    net = LearnableForwardUNetMultiScoreMap(
        nf=8, ch_mult=(1, 2), context_dim=16, score_map_chan=4, score_map_ch_mult=(1, 1),
        score_map_ngf=8, use_image_context=True, token_embed_dim=48, num_res_blocks=1)
    tree = jax_engine.state["drift"]["params"]
    load_flax_params(net, tree)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_flax_params(net, extra)
    missing = {k: v for k, v in tree.items() if k != "mid_attn"}
    with pytest.raises(KeyError, match="mid_attn"):
        load_flax_params(net, missing)


def _jax_noise(key, shape, n_steps):
    """JAX's own draws in ``DriftSDE.reverse_ddpm``: the initial noise from
    k_init, step i's from split(k_loop, n)[i]."""
    k_init, k_loop = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_init, shape))
    keys = jax.random.split(k_loop, n_steps)
    return eps, [np.asarray(jax.random.normal(k, shape)) for k in keys]


@pytest.fixture(scope="module")
def jax_samples(jax_engine, inputs):
    """JAX ``build_sample_fn`` outputs by (optimize_type, eta, sample_steps),
    each computed once and shared by the fused and the unfused port; the
    key is ``jax.random.key(5)``."""
    cache = {}

    def get(optimize_type, eta, sample_steps):
        k = (optimize_type, eta, sample_steps)
        if k not in cache:
            jax_engine.optimize_type = optimize_type
            try:
                sample = jax.jit(jax_engine.build_sample_fn(eta=eta,
                                                            sample_steps=sample_steps))
                cache[k] = np.asarray(sample(
                    jax_engine.state["d_ema"], jax_engine.state["n_ema"],
                    jax_engine.text_params, inputs["x_b"], inputs["type_idx"],
                    inputs["emb"], jax.random.key(5)))
            finally:
                jax_engine.optimize_type = "inputRes"
        return cache[k]

    return get


def _port_sample(engine, inputs, eta, sample_steps):
    """The port engine's ``test`` with JAX's noise for ``jax.random.key(5)``."""
    mu = inputs["x_b"]
    n_steps = len(strided_sampling_grid(T, sample_steps)[0])
    eps, zs = _jax_noise(jax.random.key(5), mu.shape, n_steps)
    return engine.test(
        {"input": mu, "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]},
        sample_steps=sample_steps, eta=eta, init_noise=torch.tensor(eps),
        step_noise=[torch.tensor(z) for z in zs])


@pytest.mark.parametrize("optimize_type,eta,sample_steps", [
    ("inputRes", 0.0, None), ("inputRes", 1.0, None), ("inputRes", 1.0, 2),
    ("predict_x0", 1.0, None), ("predict_std_noise_scale_drift", 0.0, 2)],
    ids=["eta0_T4", "eta1_T4", "eta1_strided2", "x0_eta1_T4", "scale_drift_eta0_strided2"])
def test_sampler_matches_build_sample_fn(jax_samples, port_engine, inputs, optimize_type,
                                         eta, sample_steps):
    """The whole slice: the port's engine ``test`` (kernel-structured UNet,
    two nets in turn) against JAX ``build_sample_fn`` (the plain graph on
    the CPU) with JAX's noise fed in, for each sampling contract."""
    want = jax_samples(optimize_type, eta, sample_steps)
    port_engine.optimize_type = optimize_type
    try:
        got = _port_sample(port_engine, inputs, eta, sample_steps)
    finally:
        port_engine.optimize_type = "inputRes"
    assert got.shape == inputs["x_b"].shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def unfused_engine(jax_engine):
    """The port engine on the unfused ResBlock body and head."""
    eng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=0.4),
                          engine_opts={"fused_gnconv": False}, device="cpu", **ENGINE_KW)
    assert not eng.nets["d_ema"].use_fused_gnconv
    return load_engine(eng, jax_engine.state, jax_engine.text_params)


@pytest.mark.parametrize("eta,sample_steps", [(0.0, None), (1.0, None), (1.0, 2)],
                         ids=["eta0_T4", "eta1_T4", "eta1_strided2"])
def test_unfused_sampler_matches_build_sample_fn(jax_samples, unfused_engine, inputs, eta,
                                                 sample_steps):
    """``engine_opts={"fused_gnconv": False}``: every ResBlock on the GN + SiLU
    kernel's plain version and a plain conv, against the same JAX graph."""
    want = jax_samples("inputRes", eta, sample_steps)
    got = _port_sample(unfused_engine, inputs, eta, sample_steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_fused_and_unfused_bodies_agree(port_engine, unfused_engine, inputs):
    """The same weights through both bodies and heads: value-identical up to
    float32 summation order."""
    i = inputs
    args = (torch.from_numpy(i["x_a"]), torch.from_numpy(i["x_b"]),
            torch.from_numpy(i["t"]), torch.from_numpy(i["type_idx"]),
            [torch.randn(5, SETTINGS["context_dim"], generator=torch.Generator().manual_seed(0))
             for _ in range(2)], torch.from_numpy(i["emb"]))
    with torch.no_grad():
        want_pred, want_maps = port_engine.nets["d_ema"](*args)
        pred, maps = unfused_engine.nets["d_ema"](*args)
    for got, want in zip([pred] + maps, [want_pred] + want_maps):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_restorer_pads_chunks_and_rejects_unknown_types(port_engine):
    r = Restorer(port_engine, batch_size=2, sample_steps=2, seed=0, device="cpu")
    calls = []
    real_test = port_engine.test

    def spy(batch, generator, **kw):
        calls.append({k: np.asarray(v) for k, v in batch.items()})
        return real_test(batch, generator, **kw)

    port_engine.test = spy
    try:
        imgs = np.random.default_rng(3).uniform(-1, 1, (3, RES, RES, 1)).astype(np.float32)
        out = r.restore(imgs, ["speckle in OCT", "Gaussian noise in MRI",
                               "noise in low dose CT"])
        assert out.shape == imgs.shape and np.isfinite(out).all()
        assert len(calls) == 2 and all(c["input"].shape[0] == 2 for c in calls)
        # the second chunk holds one image, padded in edge mode
        np.testing.assert_array_equal(calls[1]["input"][1], imgs[2])
        np.testing.assert_array_equal(calls[1]["type_idx"], [3, 3])
        with pytest.raises(KeyError, match="unknown artifact"):
            r.restore(imgs[:1], ["speckle in MRI"])
        with pytest.raises(ValueError, match="artifact types"):
            r.restore(imgs, ["speckle in OCT"] * 2)
    finally:
        del port_engine.test
