"""The port's GroupNorm + SiLU and the unfused ResBlock body against the JAX
package on the CPU.

On the CPU ``group_norm_silu`` runs its plain PyTorch version, held here
against the Pallas kernel in interpret mode with several row tiles (float32)
and against ``group_norm_silu_reference`` (bfloat16). The unfused ResBlock
body is held against JAX's ``ResBlock`` with contexts of 0, 1 and 2 tokens
(flax creates the cross-attention's ``q``, ``k`` and LayerNorm only for 2),
every parameter leaf randomised, and against the port's own fused body on
the same weights. The CUDA kernel is held against the plain version on the
card in ``test_torch_gpu.py``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.models.unet import ResBlock as JaxResBlock
from instancediff_tpu.ops import pallas_kernels as pk

from instancediff_torch.models.unet import ResBlock
from instancediff_torch.ops.group_norm_silu import group_norm_silu, group_norm_silu_plain
from instancediff_torch.utils.convert import load_flax_params

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401

# the drift decoder concats (Cg = 6, 16, 22) and the level-0 width
GN_SHAPES = [(144, 24), (272, 17), (528, 24), (64, 32)]


def _gn_inputs(C, seed):
    rng = np.random.default_rng(seed)
    # an offset mean exercises the E[x^2] - mean^2 statistics
    x = (0.5 + rng.standard_normal((2, 6, 8, C))).astype(np.float32)
    gamma = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no_silu"])
@pytest.mark.parametrize("C,G", GN_SHAPES, ids=[f"C{c}_G{g}" for c, g in GN_SHAPES])
def test_gn_plain_matches_pallas_interpret(C, G, silu):
    """48 rows in tiles of 16: the Pallas kernel accumulates over 3 tiles."""
    x, gamma, beta = _gn_inputs(C, C + G)
    want = np.asarray(pk.group_norm_silu(x, gamma, beta, G, silu=silu, tile_rows=16,
                                         interpret=True))
    got = group_norm_silu(torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), G,
                          silu=silu)  # CPU tensor -> plain version
    # float32; tiled vs one-shot sums: rounding only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,G", GN_SHAPES, ids=[f"C{c}_G{g}" for c, g in GN_SHAPES])
def test_gn_plain_bf16_matches_reference(C, G):
    """bf16 in and out, float32 inside, rounded once: the two may differ by
    one bf16 ulp (2^-7 relative) where the float32 values straddle a
    rounding boundary."""
    x, gamma, beta = _gn_inputs(C, C)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pk.group_norm_silu_reference(xb, gamma, beta, G), np.float32)
    got = group_norm_silu_plain(torch.tensor(x).bfloat16(), torch.tensor(gamma),
                                torch.tensor(beta), G)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def _randomize(tree, rng):
    """Every leaf redrawn, the zero-initialised ones (conv2, the attention
    ``out``) included."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.3 * rng.standard_normal(np.shape(a)).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def block_inputs():
    rng = np.random.default_rng(11)
    return dict(h=rng.standard_normal((2, 6, 6, 24)).astype(np.float32),
                temb=rng.standard_normal((2, 32)).astype(np.float32),
                ctx=rng.standard_normal((2, 2, 8)).astype(np.float32))


@pytest.mark.parametrize("tokens", [0, 1, 2], ids=["no_context", "1_token", "2_tokens"])
def test_unfused_resblock_matches_jax(block_inputs, tokens):
    """24 -> 16 channels (a 1x1 skip; 24 groups of 1, then 16 of 1), the
    timestep projection, and the cross-attention over ``tokens`` tokens."""
    i = block_inputs
    ctx = i["ctx"][:, :tokens] if tokens else None
    jblock = JaxResBlock(16, use_context=tokens > 0, context_dim=8)
    # jitted: one compiled program each instead of every op compiled eagerly
    params = _randomize(jax.jit(jblock.init)(jax.random.key(0), i["h"], i["temb"], ctx),
                        np.random.default_rng(tokens))
    want = np.asarray(jax.jit(jblock.apply)(params, i["h"], i["temb"], ctx))
    block = load_flax_params(ResBlock(24, 16, 32, 8, context_tokens=tokens), params)
    args = (torch.tensor(i["h"]), torch.tensor(i["temb"]),
            None if ctx is None else torch.tensor(ctx))
    with torch.no_grad():
        got = block(*args, fused=False)
        # float32; summation order only
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        if tokens <= 1:  # the fused body takes at most one token
            np.testing.assert_allclose(block(*args, fused=True).numpy(), got.numpy(),
                                       rtol=1e-5, atol=1e-5)
        else:  # more than one token always runs the unfused body
            np.testing.assert_array_equal(block(*args, fused=True).numpy(), got.numpy())
