"""The drift sampler of the PyTorch port with ``use_degra_context`` and image
context on, against the JAX engine on the CPU at the tiny size of
``test_torch_engine.py``.

The context then holds two tokens, [image | degradation]: the prompt's
text encoding without learnable context is the second. Every ResBlock takes
the unfused body with full cross-attention, whose ``q``, ``k`` and LayerNorm
flax creates only for more than one token."""

import numpy as np
import pytest

import jax
import torch

from instancediff_tpu.models.drift_model import CLIPDriftEngine as JaxEngine
from instancediff_tpu.sde import DriftSDE as JaxSDE

from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.sde import DriftSDE, strided_sampling_grid
from instancediff_torch.utils.convert import load_engine

from test_torch_engine import (ENGINE_KW, RES, SETTINGS, T, _jax_noise,  # noqa: F401
                               inits_shapes_only, one_torch_thread, randomize)

B = 2
KW = dict(ENGINE_KW, use_degra_context=True)


@pytest.fixture(scope="module")
def engines():
    with inits_shapes_only("CLIPDriftEngine"):
        jeng = JaxEngine(dnet_settings=SETTINGS, nnet_settings=SETTINGS,
                         sde=JaxSDE(T=T, max_sigma=0.4), if_train=False, image_size=RES, **KW)
    rng = np.random.default_rng(0)
    for key in ("drift", "noise", "d_ema", "n_ema"):
        jeng.state[key] = randomize(jeng.state[key], rng)
    jeng.text_params = randomize(jeng.text_params, rng)
    assert "LayerNorm_0" in jeng.state["d_ema"]["params"]["enc_0_0"]["xattn"]
    peng = CLIPDriftEngine(SETTINGS, SETTINGS, sde=DriftSDE(T=T, max_sigma=0.4),
                           device="cpu", **KW)
    return jeng, load_engine(peng, jeng.state, jeng.text_params)


def test_degra_context_sampler_matches_build_sample_fn(engines):
    jeng, peng = engines
    rng = np.random.default_rng(4)
    mu = rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32)
    type_idx = np.array([1, 3], np.int32)
    emb = rng.standard_normal((B, 1, SETTINGS["context_dim"])).astype(np.float32)
    key = jax.random.key(9)
    sample = jax.jit(jeng.build_sample_fn(eta=1.0))
    want = np.asarray(sample(jeng.state["d_ema"], jeng.state["n_ema"], jeng.text_params,
                             mu, type_idx, emb, key))
    eps, zs = _jax_noise(key, mu.shape, len(strided_sampling_grid(T)[0]))
    got = peng.test({"input": mu, "type_idx": type_idx, "A_emb": emb}, eta=1.0,
                    init_noise=torch.tensor(eps), step_noise=[torch.tensor(z) for z in zs])
    # float32, T=4 steps of two nets each: summation order only
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
