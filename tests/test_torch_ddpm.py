"""The DDPM baseline of the PyTorch port (``CLIPDDPMEngine``, ``DDPMSDE``,
the single-score-map UNet on the unfused ResBlock body) against the JAX
engine on the CPU, at a tiny size: nf 8, ch_mult (1, 2), one ResBlock per
level, 16 px, the tiny text tower, float32.

Every JAX parameter leaf is randomised before it is converted, and both
sides get the same inputs and, for the sampler, the same noise: JAX's own
draws are fed to the port. On the CPU the JAX sampler runs the unfused
graph (no fused conv, no Pallas GroupNorm, no packed level 0)."""

import os

import numpy as np
import pytest

import jax
import torch

from instancediff_tpu.models.ddpm_model import CLIPDDPMEngine as JaxDDPMEngine
from instancediff_tpu.models.ddpm_model import CLIPDDPMModel as JaxDDPMModel
from instancediff_tpu.sde.ddpm_sde import DDPMSDE as JaxDDPMSDE
from instancediff_tpu.sde.schedules import make_cosine_alphas_bar as jax_cosine_abar
from instancediff_tpu.utils import checkpoint as jax_ckpt

from instancediff_torch.models import create_model
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine, CLIPDDPMModel
from instancediff_torch.models.engine import TEXT_SIDECAR
from instancediff_torch.sde import (DDPMSDE, create_sde, make_cosine_alphas_bar,
                                    strided_sampling_grid)
from instancediff_torch.serving import Restorer
from instancediff_torch.utils import checkpoint as ckpt
from instancediff_torch.utils.convert import flax_params, load_engine

from test_torch_bundle import _assert_trees_equal, _flat
from test_torch_engine import (_jax_noise, inits_shapes_only, one_torch_thread,  # noqa: F401
                               quick_jax_compiles, randomize, run_together)

RES, B, T = 16, 2, 4
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16,
                text_module="scoremap", score_map_chan=4, score_map_ngf=8,
                num_res_blocks=1)


# the SDE the engines are built with; ``set_sde`` then gives them the one
# every sampler test uses (max_sigma 1), as the JAX drivers set theirs
BUILT_SIGMA = 0.5


@pytest.fixture(scope="module")
def jax_engine():
    with inits_shapes_only("CLIPDDPMEngine"):
        eng = JaxDDPMEngine(SETTINGS, sde=JaxDDPMSDE(T=T, max_sigma=BUILT_SIGMA),
                            image_size=RES, if_train=False, use_image_context=True,
                            tiny_text_encoder=True)
    eng.set_sde(JaxDDPMSDE(T=T))
    rng = np.random.default_rng(0)
    for key in ("noise", "n_ema"):
        eng.state[key] = randomize(eng.state[key], rng)
    eng.text_params = randomize(eng.text_params, rng)
    return eng


def _port_engine(jax_engine, sde):
    eng = CLIPDDPMEngine(SETTINGS, sde=sde, use_image_context=True, tiny_text_encoder=True,
                         device="cpu")
    return load_engine(eng, jax_engine.state, jax_engine.text_params)


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    """The port's engine with JAX's weights, given its SDE as JAX's was."""
    eng = _port_engine(jax_engine, DDPMSDE(T=T, max_sigma=BUILT_SIGMA))
    eng.set_sde(DDPMSDE(T=T))
    return eng


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return dict(
        x=rng.standard_normal((B, RES, RES, 1)).astype(np.float32),
        mu=rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
        t=np.array([4, 2], np.int32),
        type_idx=np.array([2, 0], np.int32),
        emb=rng.standard_normal((B, 1, SETTINGS["context_dim"])).astype(np.float32),
    )


def test_cosine_alphas_bar_equals_jax():
    for steps in (4, 100):
        np.testing.assert_array_equal(make_cosine_alphas_bar(steps).numpy(),
                                      np.asarray(jax_cosine_abar(steps)))


# (eta, sample_steps) of each sampler test
SAMPLERS = {"eta0_T4": (0.0, None), "eta1_T4": (1.0, None), "eta1_strided2": (1.0, 2)}
SAMPLE_KEY = 7


@pytest.fixture(scope="module")
def jax_refs(jax_engine, inputs):
    """JAX's references, computed together (``run_together``): the EMA
    net's forward (with its text encoding) and ``build_sample_fn``'s output
    for each case of ``SAMPLERS`` from ``jax.random.key(SAMPLE_KEY)``."""
    params = jax_engine.state["n_ema"]
    text_fn = jax_engine._make_text_fn(jax_engine.text_params)
    text = [np.asarray(text_fn(params["params"]["smm_0"]["context"]))]
    i = inputs
    fns = [lambda p, *a: jax_engine.noise_net.apply(p, *a[:4], text_embs=a[4],
                                                   image_context=a[5])]
    fns += [jax_engine.build_sample_fn(sample_steps=sample_steps, eta=eta)
            for eta, sample_steps in SAMPLERS.values()]
    out, = run_together(fns, [(params, i["x"], i["mu"], i["t"], i["type_idx"], text, i["emb"])]
                        + [(params, jax_engine.text_params, i["mu"], i["type_idx"], i["emb"],
                            jax.random.key(SAMPLE_KEY))] * len(SAMPLERS))
    return {"unet": (text, out[0]), **dict(zip(SAMPLERS.values(), out[1:]))}


def test_single_scoremap_unet_matches_jax(jax_refs, port_engine, inputs):
    """One SMM (level 0), so the level-1 decoder concat has no score-map
    channels; the unfused body and head on every block. Then the port's
    fused body on the same weights."""
    text, (want_pred, want_maps) = jax_refs["unet"]
    i = inputs
    net = port_engine.nets["n_ema"]
    assert not net.use_fused_gnconv and net.n_smms == 1
    args = (torch.from_numpy(i["x"]), torch.from_numpy(i["mu"]), torch.from_numpy(i["t"]),
            torch.from_numpy(i["type_idx"]), [torch.tensor(text[0])],
            torch.from_numpy(i["emb"]))
    with torch.no_grad():
        pred, maps = net(*args)
        net.use_fused_gnconv = True
        try:
            fused_pred, fused_maps = net(*args)
        finally:
            net.use_fused_gnconv = False
    assert pred.shape == (B, RES, RES, 1) and len(maps) == len(want_maps) == 1
    # float32; chained convs with random weights: summation order only
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(maps[0].numpy(), np.asarray(want_maps[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(fused_pred.numpy(), pred.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused_maps[0].numpy(), maps[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eta,sample_steps", SAMPLERS.values(), ids=SAMPLERS.keys())
def test_ddpm_sampler_matches_build_sample_fn(jax_refs, port_engine, inputs, eta,
                                              sample_steps):
    """``CLIPDDPMEngine.test`` against JAX ``build_sample_fn`` from pure noise
    with JAX's draws fed in: clipped x0, the DDIM(eta) posterior, the
    sigma^2 clip and no noise on the last step; ``get_visuals`` is the
    call's output, as JAX's is."""
    mu = inputs["mu"]
    batch = {"input": mu, "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]}
    got = _port_sample(port_engine, batch, jax.random.key(SAMPLE_KEY), sample_steps, eta)
    assert got.shape == mu.shape
    np.testing.assert_array_equal(port_engine.get_visuals(), got.numpy())
    np.testing.assert_allclose(got.numpy(), jax_refs[eta, sample_steps], rtol=0, atol=1e-4)


def _port_sample(engine, batch, key, sample_steps=None, eta=None):
    """The port engine's ``test`` with JAX's noise for ``key``."""
    n_steps = len(strided_sampling_grid(T, sample_steps)[0])
    eps, zs = _jax_noise(key, batch["input"].shape, n_steps)
    return engine.test(batch, sample_steps=sample_steps, eta=eta, init_noise=torch.tensor(eps),
                       step_noise=[torch.tensor(z) for z in zs])


def test_set_sde_after_build_samples_as_built_with_it(jax_engine, port_engine, inputs):
    """The engine that got its SDE by ``set_sde`` (held against JAX's after
    JAX's ``set_sde`` above) samples bit for bit as one built with that SDE,
    and not as one on the SDE it was built with."""
    batch = {"input": inputs["mu"], "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]}
    key = jax.random.key(SAMPLE_KEY)
    got = _port_sample(port_engine, batch, key)
    assert torch.equal(got, _port_sample(_port_engine(jax_engine, DDPMSDE(T=T)), batch, key))
    assert not torch.equal(got, _port_sample(_port_engine(jax_engine, DDPMSDE(
        T=T, max_sigma=BUILT_SIGMA)), batch, key))


@pytest.mark.parametrize("use_ema", [False, True], ids=["online", "ema"])
def test_get_nets_as_jax(jax_engine, port_engine, use_ema):
    """JAX's key, and the net (or its EMA shadow) holding JAX's weights; the
    reference config's class name ``CLIPDDPMModel`` names the engine in
    both packages."""
    nets, jax_nets = port_engine.get_nets(use_ema), jax_engine.get_nets(use_ema)
    assert list(nets) == list(jax_nets) == ["noise_net"]
    _assert_trees_equal(flax_params(nets["noise_net"]), jax_nets["noise_net"])
    assert CLIPDDPMModel is CLIPDDPMEngine and JaxDDPMModel is JaxDDPMEngine


def test_restorer_serves_the_ddpm_engine(port_engine):
    r = Restorer(port_engine, batch_size=2, sample_steps=2, seed=0, device="cpu")
    imgs = np.random.default_rng(3).uniform(-1, 1, (3, RES, RES, 1)).astype(np.float32)
    out = r.restore(imgs, "noise in cryo-EM image")
    assert out.shape == imgs.shape and np.isfinite(out).all()
    with pytest.raises(KeyError, match="engine knob"):
        CLIPDDPMEngine(SETTINGS, engine_opts={"no_such_knob": 1}, tiny_text_encoder=True,
                       device="cpu")


# ---------------------------------------------------------------- bundles

ITER = 7


@pytest.fixture(scope="module")
def jax_bundle(jax_engine, tmp_path_factory):
    """JAX's ``save`` of the engine and its text tower's sidecar."""
    d = str(tmp_path_factory.mktemp("ddpm_bundle"))
    jax_engine.save(d, ITER)
    jax_ckpt.save_pytree(jax_engine.text_params, os.path.join(d, TEXT_SIDECAR))
    return d


def _model_opt():
    return {"module_name": "ddpm_model", "class_name": "CLIPDDPMModel",
            "net_settings": SETTINGS, "tiny_text_encoder": True,
            "noise_net_lr": 1e-3, "nepoch": 3}  # training keys: accepted, not read


def test_create_model_builds_the_jax_ddpm_net(jax_engine):
    eng = create_model(None, _model_opt(), phase="test", sde=create_sde(
        {"class_name": "DDPM", "T": T}), device="cpu")
    assert isinstance(eng, CLIPDDPMEngine) and isinstance(eng.sde, DDPMSDE)
    for k in ("noise", "n_ema"):
        assert ({p: v.shape for p, v in _flat(flax_params(eng.nets[k])).items()}
                == {p: tuple(v.shape) for p, v in _flat(jax_engine.state[k]).items()})
    np.testing.assert_array_equal(eng.sde.alphas_bar.numpy(),
                                  np.asarray(jax_engine.sde.alphas_bar))


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "online"])
def test_ddpm_bundle_from_jax_samples_as_in_jax(jax_engine, port_engine, jax_bundle, inputs,
                                               use_ema):
    """JAX's bundle loaded by the port: every net's weights equal JAX's, and
    the sampler gives, bit for bit, what the port engine filled from JAX's
    state in memory gives on the same noise (the engine the sampler tests
    above hold within 1e-4 of JAX)."""
    eng = create_model(None, _model_opt(), sde=DDPMSDE(T=T), device="cpu")
    eng.load(jax_bundle, ITER)
    for k in ("noise", "n_ema"):
        _assert_trees_equal(flax_params(eng.nets[k]), jax_engine.state[k])
    _assert_trees_equal(flax_params(eng.text_encoder), jax_engine.text_params)
    batch = {"input": inputs["mu"], "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]}
    noise = torch.randn(T + 1, *inputs["mu"].shape, generator=torch.Generator().manual_seed(2))
    got, want = (e.test(batch, use_ema=use_ema, init_noise=noise[0], step_noise=list(noise[1:]))
                 for e in (eng, port_engine))
    assert torch.equal(got, want)


def test_ddpm_save_writes_jax_bytes(jax_bundle, tmp_path):
    eng = create_model(None, _model_opt(), sde=DDPMSDE(T=T), device="cpu")
    eng.load(jax_bundle, ITER)
    eng.save(str(tmp_path), ITER)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jax_bundle))
    for name in os.listdir(jax_bundle):
        with open(tmp_path / name, "rb") as f, open(os.path.join(jax_bundle, name), "rb") as g:
            assert f.read() == g.read(), name


def test_ddpm_missing_prompt_and_ema_files_as_in_jax(jax_engine, jax_bundle, tmp_path):
    """Without ``{iter}_NP`` the net keeps its prompts; without
    ``lastest_NP_ema`` the EMA net takes the online net's prompts from before
    the load; without ``lastest_NN_ema`` it is a copy of the online net: as
    JAX's ``load`` does, checked on both."""
    eng = create_model(None, _model_opt(), sde=DDPMSDE(T=T), device="cpu")
    before = flax_params(eng.nets["noise"])
    d = tmp_path / "no_prompts"
    d.mkdir()
    for name in os.listdir(jax_bundle):
        if name not in (f"{ITER}_NP.ckpt", "lastest_NP_ema.ckpt"):
            os.symlink(os.path.join(jax_bundle, name), d / name)
    eng.load(str(d), ITER)
    for k in ("noise", "n_ema"):
        net, prompts = ckpt.split_smm(flax_params(eng.nets[k]))
        _assert_trees_equal(net, ckpt.split_smm(jax_engine.state[k])[0])
        _assert_trees_equal(prompts, ckpt.split_smm(before)[1])
    saved, sample_fn = dict(jax_engine.state), jax_engine._sample_fn
    try:
        jax_engine.state["noise"] = jax_engine.state["n_ema"]  # a template to keep
        jax_engine.load(str(d), ITER)
        for k in ("noise", "n_ema"):
            _assert_trees_equal(jax.device_get(ckpt.split_smm(jax_engine.state[k])[1]),
                                ckpt.split_smm(saved["n_ema"])[1])
        os.remove(d / "lastest_NN_ema.ckpt")
        eng.load(str(d), ITER)
        jax_engine.load(str(d), ITER)
        _assert_trees_equal(flax_params(eng.nets["n_ema"]), flax_params(eng.nets["noise"]))
        _assert_trees_equal(jax.device_get(jax_engine.state["n_ema"]),
                            jax.device_get(jax_engine.state["noise"]))
    finally:
        jax_engine.state.update(saved)  # the compiled sampler takes the weights as arguments
        jax_engine._sample_fn = sample_fn
