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
import torch

from instancediff_tpu.models.drift_model import CLIPDriftEngine as JaxEngine
from instancediff_tpu.sde import DDPMSDE as JaxDDPMSDE
from instancediff_tpu.sde import DriftSDE as JaxSDE
from instancediff_tpu.sde.schedules import make_schedule as jax_make_schedule
from instancediff_tpu.sde.schedules import strided_sampling_grid as jax_grid

from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.scoremap import ScoreMapModule
from instancediff_torch.models.text_encoder import build_text_encoder
from instancediff_torch.models.unet import LearnableForwardUNetMultiScoreMap
from instancediff_torch.sde import DDPMSDE, DriftSDE
from instancediff_torch.sde.schedules import make_schedule, strided_sampling_grid
from instancediff_torch.serving import Restorer
from instancediff_torch.utils.convert import flax_params, load_engine, load_flax_params

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
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), traced[key])
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


def run_together(fns, *arg_lists):
    """``[[fn(*args) for fn, args in zip(fns, arg_list)] for arg_list in
    arg_lists]`` as numpy trees, every ``fn`` traced into ONE jitted program
    that each arg list runs: a file's JAX references compile together in
    about two thirds of the time they take one by one (XLA shares their
    common parts and the fixed cost of each program)."""
    program = jax.jit(lambda arg_list: [fn(*args) for fn, args in zip(fns, arg_list)])
    return [[jax.tree.map(np.asarray, out) for out in program(arg_list)]
            for arg_list in arg_lists]


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


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """The JAX references compiled with most of XLA's optimisations off
    (``jax_disable_most_optimizations``): the parity files' tiny programs
    compile about a quarter faster and run as fast, and their values stay
    within the tests' tolerances. Restored afterwards, and JAX's caches
    cleared, so that no executable compiled so outlives the module: a file
    that needs JAX's bytes as its defaults give them (``test_torch_bundle``'s
    golden hashes) leaves it out."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", was)
    jax.clear_caches()


# the SDE the engines are built with; ``set_sde`` then gives them the one
# every sampler test uses (max_sigma 0.4), as the JAX drivers set theirs
BUILT_SIGMA = 0.6


@pytest.fixture(scope="module")
def jax_engine():
    """The tiny JAX engine with every parameter leaf randomised, given its
    sampler's SDE by ``set_sde``."""
    with inits_shapes_only("CLIPDriftEngine"):
        eng = JaxEngine(dnet_settings=SETTINGS, nnet_settings=SETTINGS,
                        sde=JaxSDE(T=T, max_sigma=BUILT_SIGMA), if_train=False,
                        image_size=RES, **ENGINE_KW)
    eng.set_sde(JaxSDE(T=T, max_sigma=0.4))
    rng = np.random.default_rng(0)
    for key in ("drift", "noise", "d_ema", "n_ema"):
        eng.state[key] = randomize(eng.state[key], rng)
    eng.text_params = randomize(eng.text_params, rng)
    return eng


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    """The port's engine with JAX's weights, given its SDE as JAX's was."""
    eng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=BUILT_SIGMA),
                          device="cpu", **ENGINE_KW)
    eng.set_sde(DriftSDE(T=T, max_sigma=0.4))
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


SMM_SIZES = (8, 32)  # unpooled (8x8) and pooled (32x32 -> 16x16 memory) score maps
SPLICED_CTX = np.random.default_rng(2).standard_normal((8, 48)).astype(np.float32)


def _smm_case(hw):
    """The score map module's inputs at ``hw``, its JAX module and the rng
    its parameters are randomised from."""
    from instancediff_tpu.models.scoremap import ScoreMapModule as JaxSMM

    rng = np.random.default_rng(hw)
    vis = rng.standard_normal((2, hw, hw, 12)).astype(np.float32)
    text = rng.standard_normal((5, 16)).astype(np.float32)
    return vis, text, JaxSMM(visual_dim=8, token_embed_dim=24, embed_dim=16), rng


@pytest.fixture(scope="module")
def jax_forwards(jax_engine, inputs):
    """JAX's references of the forward tests, computed together
    (``run_together``): the text tower with spliced context; the score map
    modules (their inits, randomised, then their applies); the drift UNet as
    built and as the sampler's ``use_fused_gnconv=True, flash_mid=True``
    clone (on the CPU: the fused conv's jnp reference, flash in interpret
    mode), with the EMA net's text encodings."""
    eng, i = jax_engine, inputs
    params = eng.state["d_ema"]
    text = _jax_text(eng, params)
    nets = {"plain_net": eng.drift_net,
            "fused_flash_clone": eng.drift_net.clone(use_fused_gnconv=True, flash_mid=True)}
    smms = {hw: _smm_case(hw) for hw in SMM_SIZES}
    fns = [lambda p, ids, c: eng.text_encoder.apply(p, ids, c)]
    args = [(eng.text_params, eng.prompt_ids, SPLICED_CTX)]
    for net in nets.values():
        fns.append(lambda p, *a, net=net: net.apply(p, *a[:4], text_embs=a[4],
                                                    image_context=a[5]))
        args.append((params, i["x_a"], i["x_b"], i["t"], i["type_idx"], text, i["emb"]))
    for vis, txt, smm, _ in smms.values():
        fns.append(smm.init)
        args.append((jax.random.key(0), vis, txt))
    out, = run_together(fns, args)
    smm_params = {hw: randomize(p, smms[hw][3]) for hw, p in zip(SMM_SIZES, out[3:])}
    applied, = run_together([smms[hw][2].apply for hw in SMM_SIZES],
                            [(smm_params[hw], *smms[hw][:2]) for hw in SMM_SIZES])
    return {"text": out[0], "unet": dict(zip(nets, out[1:3])), "unet_text": text,
            "smm": {hw: (smm_params[hw], want) for hw, want in zip(SMM_SIZES, applied)}}


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


def test_text_tower_with_spliced_context(jax_forwards, port_engine):
    want = jax_forwards["text"]
    with torch.no_grad():
        got = port_engine.text_encoder(port_engine.prompt_ids, torch.from_numpy(SPLICED_CTX))
    # float32 on both sides; differences are summation order only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_full_size_text_tower_shapes():
    enc, token_dim = build_text_encoder(512)
    assert token_dim == 512 and enc.layers == 12 and enc.context_length == 42
    assert enc.token_embedding.weight.shape == (49408, 512)


@pytest.mark.parametrize("hw", SMM_SIZES)
def test_scoremap_module(jax_forwards, hw):
    """Unpooled (8x8) and pooled (32x32 -> 16x16 memory) score maps."""
    vis, text, _, _ = _smm_case(hw)
    params, want = jax_forwards["smm"][hw]
    smm = load_flax_params(ScoreMapModule(12, 8, token_embed_dim=24, embed_dim=16), params)
    with torch.no_grad():
        got = smm(torch.from_numpy(vis), torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("net", ["plain_net", "fused_flash_clone"])
def test_unet_forward(jax_forwards, port_engine, inputs, net):
    """Prediction and every score map against the JAX UNet, both as built
    and as the sampler's ``use_fused_gnconv=True, flash_mid=True`` clone
    (on the CPU: the fused conv's jnp reference, flash in interpret mode)."""
    want_pred, want_maps = jax_forwards["unet"][net]
    text = jax_forwards["unet_text"]
    i = inputs
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


# (optimize_type, eta, sample_steps) of each sampling contract tested
SAMPLERS = {"eta0_T4": ("inputRes", 0.0, None), "eta1_T4": ("inputRes", 1.0, None),
            "eta1_strided2": ("inputRes", 1.0, 2), "x0_eta1_T4": ("predict_x0", 1.0, None),
            "scale_drift_eta0_strided2": ("predict_std_noise_scale_drift", 0.0, 2)}


@pytest.fixture(scope="module")
def jax_samples(jax_engine, inputs):
    """JAX ``build_sample_fn`` outputs by (optimize_type, eta, sample_steps),
    shared by the fused and the unfused port; the key is
    ``jax.random.key(5)``. Each (optimize_type, sample_steps) is traced once
    into one program (``run_together``) with eta an input (JAX's sampler
    takes eta into its arithmetic only), which runs once per eta a contract
    is tested at."""
    args = (jax_engine.state["d_ema"], jax_engine.state["n_ema"], jax_engine.text_params,
            inputs["x_b"], inputs["type_idx"], inputs["emb"], jax.random.key(5))

    def contract(optimize_type, sample_steps):
        def sample(eta, *a):
            jax_engine.optimize_type = optimize_type  # read while tracing
            try:
                return jax_engine.build_sample_fn(eta=eta, sample_steps=sample_steps)(*a)
            finally:
                jax_engine.optimize_type = "inputRes"
        return sample

    etas = {}
    for optimize_type, eta, sample_steps in SAMPLERS.values():
        etas.setdefault((optimize_type, sample_steps), []).append(eta)
    runs = max(map(len, etas.values()))
    outs = run_together([contract(*k) for k in etas],
                        *[[(np.float32(e[min(r, len(e) - 1)]), *args) for e in etas.values()]
                          for r in range(runs)])
    cache = {(k[0], e, k[1]): outs[r][j] for j, (k, es) in enumerate(etas.items())
             for r, e in enumerate(es)}
    return lambda *case: cache[case]


def _port_sample(engine, inputs, eta, sample_steps):
    """The port engine's ``test`` with JAX's noise for ``jax.random.key(5)``."""
    mu = inputs["x_b"]
    n_steps = len(strided_sampling_grid(T, sample_steps)[0])
    eps, zs = _jax_noise(jax.random.key(5), mu.shape, n_steps)
    return engine.test(
        {"input": mu, "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]},
        sample_steps=sample_steps, eta=eta, init_noise=torch.tensor(eps),
        step_noise=[torch.tensor(z) for z in zs])


@pytest.mark.parametrize("optimize_type,eta,sample_steps", SAMPLERS.values(),
                         ids=SAMPLERS.keys())
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


def test_set_sde_after_build_samples_as_built_with_it(jax_engine, jax_samples, port_engine,
                                                      inputs):
    """The engine that got its SDE by ``set_sde`` samples bit for bit as one
    built with that SDE, not as one on the SDE it was built with, and as
    JAX's engine after JAX's ``set_sde`` (within the sampler tests' 1e-4);
    ``get_visuals`` is the last call's output, as JAX's is."""
    def built(max_sigma):
        eng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=max_sigma),
                              device="cpu", **ENGINE_KW)
        return _port_sample(load_engine(eng, jax_engine.state, jax_engine.text_params),
                            inputs, 1.0, None)

    got = _port_sample(port_engine, inputs, 1.0, None)
    np.testing.assert_array_equal(port_engine.get_visuals(), got.numpy())
    assert torch.equal(got, built(0.4))
    assert not torch.equal(got, built(BUILT_SIGMA))
    np.testing.assert_allclose(port_engine.get_visuals(), jax_samples("inputRes", 1.0, None),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_ema", [False, True], ids=["online", "ema"])
def test_get_nets_as_jax(jax_engine, port_engine, use_ema):
    """JAX's keys, and the nets (or EMA shadows) holding JAX's weights."""
    nets, jax_nets = port_engine.get_nets(use_ema), jax_engine.get_nets(use_ema)
    assert list(nets) == list(jax_nets) == ["drift_net", "noise_net"]
    for k, net in nets.items():
        jax.tree.map(np.testing.assert_array_equal, flax_params(net),
                     jax.device_get(jax_nets[k]))


def test_jax_accessor_names(jax_engine, port_engine):
    """``get_smm_contexts`` / ``get_context`` return the port's own
    ``smm_contexts``, JAX's learnable context tokens; each SDE's ``set_gpu``
    returns the SDE, as JAX's does."""
    net = port_engine.nets["d_ema"]
    ctxs = net.get_smm_contexts()
    assert all(a is b for a, b in zip(ctxs, net.smm_contexts()))
    assert ctxs[0] is net.smm_0.get_context()
    want = jax_engine.drift_net.apply(jax_engine.state["d_ema"], method="get_smm_contexts")
    assert len(ctxs) == len(want) == 2
    for got, w in zip(ctxs, want):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(w))
    for sde, jax_sde in ((DriftSDE(T=T), JaxSDE(T=T)), (DDPMSDE(T=T), JaxDDPMSDE(T=T))):
        assert sde.set_gpu("cpu") is sde and jax_sde.set_gpu() is jax_sde


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
