"""The DDPM baseline of the PyTorch port (``CLIPDDPMEngine``, ``DDPMSDE``,
the single-score-map UNet on the unfused ResBlock body) against the JAX
engine on the CPU, at a tiny size: nf 8, ch_mult (1, 2), one ResBlock per
level, 16 px, the tiny text tower, float32.

Every JAX parameter leaf is randomised before it is converted, and both
sides get the same inputs and, for the sampler, the same noise: JAX's own
draws are fed to the port. On the CPU the JAX sampler runs the unfused
graph (no fused conv, no Pallas GroupNorm, no packed level 0)."""

import numpy as np
import pytest

import jax
import torch

from instancediff_tpu.models.ddpm_model import CLIPDDPMEngine as JaxDDPMEngine
from instancediff_tpu.sde.ddpm_sde import DDPMSDE as JaxDDPMSDE
from instancediff_tpu.sde.schedules import make_cosine_alphas_bar as jax_cosine_abar

from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.sde import DDPMSDE, make_cosine_alphas_bar, strided_sampling_grid
from instancediff_torch.serving import Restorer
from instancediff_torch.utils.convert import load_engine

from test_torch_engine import _jax_noise, randomize

RES, B, T = 16, 2, 4
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16,
                text_module="scoremap", score_map_chan=4, score_map_ngf=8,
                num_res_blocks=1)


@pytest.fixture(scope="module")
def jax_engine():
    eng = JaxDDPMEngine(SETTINGS, sde=JaxDDPMSDE(T=T), image_size=RES, if_train=False,
                        use_image_context=True, tiny_text_encoder=True)
    rng = np.random.default_rng(0)
    for key in ("noise", "n_ema"):
        eng.state[key] = randomize(eng.state[key], rng)
    eng.text_params = randomize(eng.text_params, rng)
    return eng


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    eng = CLIPDDPMEngine(SETTINGS, sde=DDPMSDE(T=T), use_image_context=True,
                         tiny_text_encoder=True, device="cpu")
    return load_engine(eng, jax_engine.state, jax_engine.text_params)


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


def test_single_scoremap_unet_matches_jax(jax_engine, port_engine, inputs):
    """One SMM (level 0), so the level-1 decoder concat has no score-map
    channels; the unfused body and head on every block. Then the port's
    fused body on the same weights."""
    params = jax_engine.state["n_ema"]
    text_fn = jax_engine._make_text_fn(jax_engine.text_params)
    text = [np.asarray(text_fn(params["params"]["smm_0"]["context"]))]
    i = inputs
    want_pred, want_maps = jax_engine.noise_net.apply(
        params, i["x"], i["mu"], i["t"], i["type_idx"], text_embs=text,
        image_context=i["emb"])
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


@pytest.mark.parametrize("eta,sample_steps", [(0.0, None), (1.0, None), (1.0, 2)],
                         ids=["eta0_T4", "eta1_T4", "eta1_strided2"])
def test_ddpm_sampler_matches_build_sample_fn(jax_engine, port_engine, inputs, eta,
                                              sample_steps):
    """``CLIPDDPMEngine.test`` against JAX ``build_sample_fn`` from pure noise
    with JAX's draws fed in: clipped x0, the DDIM(eta) posterior, the
    sigma^2 clip and no noise on the last step."""
    mu, key = inputs["mu"], jax.random.key(7)
    sample = jax.jit(jax_engine.build_sample_fn(sample_steps=sample_steps, eta=eta))
    want = np.asarray(sample(jax_engine.state["n_ema"], jax_engine.text_params, mu,
                             inputs["type_idx"], inputs["emb"], key))
    n_steps = len(strided_sampling_grid(T, sample_steps)[0])
    eps, zs = _jax_noise(key, mu.shape, n_steps)
    got = port_engine.test(
        {"input": mu, "type_idx": inputs["type_idx"], "A_emb": inputs["emb"]},
        sample_steps=sample_steps, eta=eta, init_noise=torch.tensor(eps),
        step_noise=[torch.tensor(z) for z in zs])
    assert got.shape == mu.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_restorer_serves_the_ddpm_engine(port_engine):
    r = Restorer(port_engine, batch_size=2, sample_steps=2, seed=0, device="cpu")
    imgs = np.random.default_rng(3).uniform(-1, 1, (3, RES, RES, 1)).astype(np.float32)
    out = r.restore(imgs, "noise in cryo-EM image")
    assert out.shape == imgs.shape and np.isfinite(out).all()
    with pytest.raises(KeyError, match="engine knob"):
        CLIPDDPMEngine(SETTINGS, engine_opts={"no_such_knob": 1}, tiny_text_encoder=True,
                       device="cpu")
