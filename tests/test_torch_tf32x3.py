"""The split-TF32 (3xTF32) arithmetic of the port's fp32 CUDA kernels, on the
CPU, against the JAX package's Pallas kernels in interpret mode.

On the card, ``csrc/flash_attention.cu:flash_tf32x3_kernel`` and
``csrc/fused_gn_silu_conv3x3.cu:fgc_tf32x3_kernel`` take every fp32 product
on the tensor cores as three TF32 products: each operand a is split into
big = rna(a) and small = rna(a - big) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, to 10 mantissa bits), and a*b is taken as
small*big + big*small + big*big with fp32 accumulation. A product of two
TF32 values is exact in fp32, so a float32 matmul or conv of TF32-valued
operands is that arithmetic, in another summation order. This file holds
that model within the fp32 tolerance (1e-5) of the Pallas kernels, and shows
that one TF32 pass (big*big alone) is not: the reason for three.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instancediff_tpu.ops import pallas_kernels as pk

from instancediff_torch.ops.fused_gn_conv import SLICE, pack_weights_tf32x3, split_tf32

TOL = 1e-5  # the fp32 limit the card's tests hold the kernels to


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def rna_numpy(a):
    """The RNA rounding to TF32 on the bits: (bits + 0x1000) & 0xFFFFE000."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32x3_matmul(a, b, passes=3):
    """a @ b (float32, [..., M, K] @ [..., K, N]) as the kernels take it:
    small*big + big*small + big*big, fp32 sums; ``passes=1``: big*big only."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def flash_model(q, k, v, passes=3):
    """The fp32 flash kernel's arithmetic: S = Q K^T in split TF32, the
    softmax weights unnormalised, P V in split TF32 (P split too), one
    division by the row sums."""
    s = tf32x3_matmul(q, k.transpose(-1, -2), passes) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return tf32x3_matmul(p, v, passes) / p.sum(-1, keepdim=True)


def conv_model(x, scale, shift, w, bias, res=None, passes=3):
    """The fp32 fused conv kernel's arithmetic: SiLU(x*scale + shift) in
    fp32, 0 outside the image; each product in split TF32, fp32 sums; +
    bias (+ residual)."""
    u = x * scale[:, None, None, :] + shift[:, None, None, :]
    a = (u * torch.sigmoid(u)).permute(0, 3, 1, 2)
    wk = w.permute(3, 2, 0, 1)
    ab, as_ = split_tf32(a)
    wb, ws = split_tf32(wk)
    y = F.conv2d(ab, wb, padding=1)
    if passes == 3:
        y = F.conv2d(as_, wb, padding=1) + F.conv2d(ab, ws, padding=1) + y
    y = y.permute(0, 2, 3, 1) + bias[:, None, None, :]
    return y if res is None else y + res


def _flash_inputs(D):
    rng = np.random.default_rng(100 + D)
    return tuple(_rand(rng, 2, 4, 64, D) for _ in range(3))


def _conv_inputs(C, Cout, residual):
    rng = np.random.default_rng(C * 10 + Cout)
    B, H, W = 2, 8, 6
    x = _rand(rng, B, H, W, C)
    scale = (1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32)
    shift = _rand(rng, B, C, scale=0.3)
    w = _rand(rng, 3, 3, C, Cout, scale=(9 * C) ** -0.5)
    bias = _rand(rng, B, Cout, scale=0.1)
    res = _rand(rng, B, H, W, Cout) if residual else None
    return x, scale, shift, w, bias, res


def _pallas_conv(x, scale, shift, w, bias, res):
    return np.asarray(pk.fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res,
                                               row_tile=4, interpret=True))


CONV_CASES = [(20, 5, False), (24, 16, True)]


def test_split_tf32_is_the_rna_rounding():
    """``split_tf32`` (the wrapper's weight packing, the kernels' model)
    rounds as ``cvt.rna.tf32.f32``: ties away from zero, for either sign,
    and big + small carries the fp32 value to ~2^-22 relative."""
    rng = np.random.default_rng(0)
    mant = np.uint32(0x3F800000)
    ties = np.array([mant | 0x1000, mant | 0x3000, mant | 0x0FFF, mant | 0x1001],
                    np.uint32).view(np.float32)
    x = np.concatenate([_rand(rng, 4096, scale=100.0), ties, -ties, [0.0, -0.0, 1e-30]])
    x = x.astype(np.float32)
    big, small = split_tf32(_t(x))
    np.testing.assert_array_equal(big.numpy().view(np.uint32), rna_numpy(x).view(np.uint32))
    np.testing.assert_array_equal(small.numpy().view(np.uint32),
                                  rna_numpy(x - rna_numpy(x)).view(np.uint32))
    assert float(big[4096]) == 1.0 + 2 ** -10 and float(big[4097]) == 1.0 + 2 ** -9
    assert float(big[4098]) == 1.0 and float(big[4099]) == 1.0 + 2 ** -10
    assert not (big.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (small.numpy().view(np.uint32) & 0x1FFF).any()
    rel = np.abs(x - (big + small).numpy()) / np.maximum(np.abs(x), 1e-30)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("D", [4, 8, 64, 128])
def test_flash_tf32x3_matches_pallas_interpret(D):
    """The fp32 flash kernel's arithmetic at the head widths of the repo's
    configurations (4: tiny_cpu.yml, 8: the demos, 64: the flagship and
    the ViT tower, 128: nf 128) against JAX's Pallas kernel."""
    q, k, v = _flash_inputs(D)
    want = np.asarray(pk.flash_attention(q, k, v, q_tile=32, kv_tile=32, interpret=True))
    got = flash_model(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C,Cout,residual", CONV_CASES)
def test_conv_tf32x3_matches_pallas_interpret(C, Cout, residual):
    """The fp32 fused conv kernel's arithmetic (ragged C = 20 with the Cout
    = 5 head; C = 24 with a residual) against JAX's Pallas kernel."""
    x, scale, shift, w, bias, res = _conv_inputs(C, Cout, residual)
    want = _pallas_conv(x, scale, shift, w, bias, res)
    got = conv_model(_t(x), _t(scale), _t(shift), _t(w), _t(bias),
                     None if res is None else _t(res))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["flash64", "flash128", "conv20", "conv24"])
def test_one_tf32_pass_misses_the_fp32_tolerance(case):
    """big*big alone (one TF32 pass, 2^-11 relative per operand) lands
    outside 1e-5 of the Pallas kernels on the same inputs; the three passes
    do not (above)."""
    if case.startswith("flash"):
        q, k, v = _flash_inputs(int(case[5:]))
        want = np.asarray(pk.flash_attention(q, k, v, q_tile=32, kv_tile=32, interpret=True))
        one = flash_model(_t(q), _t(k), _t(v), passes=1).numpy()
        three = flash_model(_t(q), _t(k), _t(v)).numpy()
    else:
        C, Cout, residual = next(c for c in CONV_CASES if c[0] == int(case[4:]))
        x, scale, shift, w, bias, res = _conv_inputs(C, Cout, residual)
        want = _pallas_conv(x, scale, shift, w, bias, res)
        args = (_t(x), _t(scale), _t(shift), _t(w), _t(bias), None if res is None else _t(res))
        one = conv_model(*args, passes=1).numpy()
        three = conv_model(*args).numpy()
    err_one = np.abs(one - want).max()
    err_three = np.abs(three - want).max()
    assert err_one > 10 * TOL, err_one
    assert err_three < TOL and err_three < err_one / 30, (err_three, err_one)


def test_pack_weights_tf32x3_layout():
    """[nblock][slice][tap][big | small][nb][32], zero past C and Cout, the
    halves summing to the weight within 2^-21 relative."""
    C, Cout, nb = 40, 11, 8
    w = torch.randn(3, 3, C, Cout, generator=torch.Generator().manual_seed(1))
    wp = pack_weights_tf32x3(w, nb)
    assert wp.shape == (2, 2, 9, 2, nb, SLICE) and wp.dtype == torch.float32
    big, small = split_tf32(w)
    for blk in range(2):
        for s in range(2):
            for tap in range(9):
                c0, co0 = s * SLICE, blk * nb
                c1, co1 = min(C, c0 + SLICE), min(Cout, co0 + nb)
                got = wp[blk, s, tap]
                ref_b = torch.zeros(nb, SLICE)
                ref_s = torch.zeros(nb, SLICE)
                ref_b[:co1 - co0, :c1 - c0] = big[tap // 3, tap % 3, c0:c1, co0:co1].T
                ref_s[:co1 - co0, :c1 - c0] = small[tap // 3, tap % 3, c0:c1, co0:co1].T
                assert torch.equal(got[0], ref_b) and torch.equal(got[1], ref_s)
    whole = wp[:, :, :, 0] + wp[:, :, :, 1]
    back = whole.permute(2, 1, 4, 0, 3).reshape(9, 2 * SLICE, 2 * nb)[:, :C, :Cout]
    torch.testing.assert_close(back, w.reshape(9, C, Cout), rtol=2 ** -21, atol=0)
