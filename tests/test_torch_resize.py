"""``ops/resize.py`` against ``jax.image.resize`` on the CPU: every method
name JAX takes, up and down, at integer and non-integer ratios, float32 and
bfloat16; and the separable weights the towers' position tables resample
with (``models/pos_embed.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from instancediff_torch.models import pos_embed
from instancediff_torch.ops.resize import downsample_label, resize_like, resize_weights

from test_torch_engine import one_torch_thread  # noqa: F401  (autouse)

NAMES = ("nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic",
         "tricubic", "lanczos3", "lanczos5")
# (H, W) -> (h, w): x2 and 16->9; /2 and 7->5; /4 and 5->7
SIZES = {"up2_16to9": ((8, 16), (16, 9)), "down2_7to5": ((8, 7), (4, 5)),
         "down4_5to7": ((16, 5), (4, 7))}


def _inputs(H, W):
    return np.random.default_rng(H * 100 + W).standard_normal((2, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_resized():
    """``jax.image.resize`` of every case, in one compiled program (one
    compile instead of one per shape and method): {(method, size id): fp32
    result}, and the bf16 case's under (method, "bf16")."""
    xb = np.random.default_rng(3).uniform(-1, 1, (2, 7, 16, 3)).astype(np.float32)

    def run(xs, xb):
        out = {}
        for method in NAMES:
            for (k, (_, (h, w))), x in zip(SIZES.items(), xs):
                out[method, k] = jax.image.resize(x, (2, h, w, 3), method)
            out[method, "bf16"] = jax.image.resize(xb.astype(jnp.bfloat16), (2, 5, 9, 3),
                                                   method).astype(jnp.float32)
        return out

    xs = [_inputs(H, W) for (H, W), _ in SIZES.values()]
    return {k: np.asarray(v) for k, v in jax.jit(run)(xs, xb).items()}, xb


@pytest.mark.parametrize("size", SIZES, ids=SIZES.keys())
@pytest.mark.parametrize("method", NAMES)
def test_resize_like_matches_jax(jax_resized, method, size):
    (H, W), (h, w) = SIZES[size]
    got = resize_like(torch.from_numpy(_inputs(H, W)), h, w, method)
    assert got.shape == (2, h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_resized[0][method, size], rtol=0, atol=1e-5)


def test_resize_like_bf16_matches_jax(jax_resized):
    """bfloat16 in and out, the weights rounded to it, at 7x16 -> 5x9."""
    want, x = jax_resized
    xb = torch.from_numpy(x).bfloat16()
    for method in NAMES:
        got = resize_like(xb, 5, 9, method)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want[method, "bf16"], rtol=0,
                                   atol=1e-2, err_msg=method)


def test_unknown_method_raises_as_jax_does():
    x = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="Unknown resize method"):
        resize_like(x, 2, 2, "area")
    with pytest.raises(ValueError, match="Unknown resize method"):
        jax.image.resize(jnp.zeros((1, 4, 4, 1)), (1, 2, 2, 1), "area")


def test_downsample_label_is_antialiased_bilinear():
    """The score-map labels keep torch's antialiased bilinear, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 16, 1))
                         .astype(np.float32))
    for mult in (1, 2, 4, 8):
        want = F.interpolate(x.permute(0, 3, 1, 2), size=(16 // mult, 16 // mult),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)
        assert torch.equal(downsample_label(x, mult), x if mult == 1 else want)


def _cubic_weights(n_in, n_out):
    """The position tables' cubic weights written out on their own (float32
    math, JAX's ``compute_weight_mat`` with Keys' kernel, antialiased)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    w = np.where(x >= 2.0, 0.0, out).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def _linear_weights(n_in, n_out):
    """The RN pool's and the dense ViT's bilinear weights written out on
    their own (the triangle kernel, no antialiasing)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def test_pos_embed_weights_and_tables_bit_for_bit():
    """``resize_weights`` gives the position tables' weights bit for bit,
    and the tables resampled with them follow."""
    for n_in in range(1, 20):
        for n_out in range(1, 20):
            assert np.array_equal(resize_weights(n_in, n_out, "cubic"),
                                  _cubic_weights(n_in, n_out)), (n_in, n_out)
            assert np.array_equal(resize_weights(n_in, n_out, "linear", antialias=False),
                                  _linear_weights(n_in, n_out)), (n_in, n_out)
    pos = np.random.default_rng(5).standard_normal((1 + 7 * 7, 8)).astype(np.float32)
    w = torch.from_numpy(_cubic_weights(7, 5)).double()
    grid = torch.einsum("hwd,hy,wx->yxd", torch.from_numpy(pos[1:]).reshape(7, 7, 8).double(),
                        w, w).float()
    assert torch.equal(pos_embed.interpolate_pos_embed(pos, 1 + 25),
                       torch.cat([torch.from_numpy(pos[:1]), grid.reshape(25, 8)]))
    w = torch.from_numpy(_linear_weights(7, 9)).double()
    grid = torch.einsum("hwd,hy,wx->yxd", torch.from_numpy(pos[1:]).reshape(7, 7, 8).double(),
                        w, w).float()
    assert torch.equal(pos_embed.resample_grid_rows(pos, 81),
                       torch.cat([torch.from_numpy(pos[:1]), grid.reshape(81, 8)]))
