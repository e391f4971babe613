"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one: the kernels have no
CPU mode. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from instancediff_torch.ops.flash_attention import flash_attention, flash_attention_plain
from instancediff_torch.ops import _build
from instancediff_torch.ops.fused_gn_conv import (
    fused_gn_silu_conv3x3,
    fused_gn_silu_conv3x3_plain,
    gn_channel_affine,
    gn_channel_affine_plain,
    tc_smem_bytes,
)
from instancediff_torch.ops.group_norm_silu import (
    CLUSTER,
    cluster_smem_bytes,
    gn_plan,
    group_norm_silu,
    group_norm_silu_cuda,
    group_norm_silu_plain,
    stats_smem_bytes,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    # the plain versions in full fp32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return scale * torch.randn(*shape, generator=gen, device=gen.device)


# fp32: summation order only; bf16: the stored result may differ by one bf16
# ulp (2^-8 relative) where the fp32 sums straddle a rounding boundary
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("C,Cout,residual", [(20, 5, False), (144, 64, True),
                                             (64, 130, True), (528, 256, False)])
def test_fused_conv_kernel_matches_plain(cuda, dtype, tol, C, Cout, residual):
    """Ragged C (20, 144, 528), Cout = 5 and a Cout past one 64-wide tile,
    odd H and W, with and without the residual."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    B, H, W = 2, 19, 23
    x = _randn(gen, B, H, W, C).to(dtype)
    scale = 1 + _randn(gen, B, C, scale=0.2)
    shift = _randn(gen, B, C, scale=0.3)
    w = _randn(gen, 3, 3, C, Cout, scale=(9 * C) ** -0.5)
    bias = _randn(gen, B, Cout, scale=0.1)
    res = _randn(gen, B, H, W, Cout).to(dtype) if residual else None
    before = fused_gn_silu_conv3x3.launches
    got = fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res)
    torch.cuda.synchronize()
    assert fused_gn_silu_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, W, Cout)
    want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias, residual=res)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _conv_case(gen, B, H, W, C, Cout, residual, dtype):
    x = _randn(gen, B, H, W, C).to(dtype)
    scale = 1 + _randn(gen, B, C, scale=0.2)
    shift = _randn(gen, B, C, scale=0.3)
    w = _randn(gen, 3, 3, C, Cout, scale=(9 * C) ** -0.5)
    bias = _randn(gen, B, Cout, scale=0.1)
    res = _randn(gen, B, H, W, Cout).to(dtype) if residual else None
    return x, scale, shift, w, bias, res


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("H,W,C,Cout,residual", [(28, 28, 272, 128, False), (30, 17, 64, 5, False),
                                                 (5, 7, 64, 5, True), (3, 9, 20, 130, False),
                                                 (96, 96, 64, 160, True)])
def test_fused_conv_kernel_tile_edges(cuda, dtype, tol, H, W, C, Cout, residual):
    """The bf16 kernel's 16x8 and 8x8 tiles, cut by the image edge: a 28x28
    decoder level at C=272 (a ragged last 32-channel slice), the Cout=5 head
    (an 8-wide N block), images smaller than one tile, C=20 (the scalar
    halo path) with Cout=130 (several N blocks), and Cout=160 (one 256-wide
    N block)."""
    gen = torch.Generator(device=cuda).manual_seed(H * W + C)
    x, scale, shift, w, bias, res = _conv_case(gen, 2, H, W, C, Cout, residual, dtype)
    got = fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res)
    torch.cuda.synchronize()
    want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias, residual=res)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_repeat_bit_for_bit(cuda, dtype):
    """No atomics and no split-K: the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, scale, shift, w, bias, res = _conv_case(gen, 4, 40, 40, 144, 64, True, dtype)
    a = fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res)
    b = fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res)
    assert torch.equal(a, b)
    q, k, v = (_randn(gen, 2, 4, 784, 64).to(dtype) for _ in range(3))
    assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


def test_conv_plan_matches_kernel_shared_memory(cuda):
    """The Python plan's shared-memory count is the kernel's own."""
    lib = _build.load("fused_gn_silu_conv3x3")
    for th in (8, 16):
        for nb in (8, 64, 128, 256):
            for stages in (2, 4):
                assert lib.fgc_tc_smem_bytes(th, nb, stages) == tc_smem_bytes(th, nb, stages)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N", [256, 200, 784])
def test_flash_kernel_matches_plain(cuda, dtype, tol, N):
    """N = 200 and 784 are ragged for the 64-row query and 64-key tiles."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = (_randn(gen, 2, 4, N, 64).to(dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# fp32: summation order only; bf16: one bf16 ulp (2^-8 relative to values
# up to ~4 after the normalise) where the fp32 values straddle a rounding
# boundary
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C,G,silu", [(144, 24, True), (272, 17, True), (528, 24, False),
                                      (64, 32, True), (20, 5, True)])
def test_gn_kernel_matches_plain(cuda, dtype, tol, C, G, silu):
    """Groups of 6, 16 and 22 channels that 8-wide bf16 loads straddle, and
    C = 20, which takes the scalar path in bf16; odd H and W."""
    gen = torch.Generator(device=cuda).manual_seed(C)
    x = (0.5 + _randn(gen, 3, 19, 23, C)).to(dtype)
    gamma = 1 + _randn(gen, C, scale=0.2)
    beta = _randn(gen, C, scale=0.3)
    before = group_norm_silu.launches
    got = group_norm_silu(x, gamma, beta, G, silu=silu)
    torch.cuda.synchronize()
    assert group_norm_silu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = group_norm_silu_plain(x, gamma, beta, G, silu=silu)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = group_norm_silu(x, gamma, beta, G, silu=silu)
    assert torch.equal(got, again)  # no atomics: bit for bit


def _gn_case(gen, B, H, W, C, dtype):
    x = (0.5 + _randn(gen, B, H, W, C)).to(dtype)
    return x, 1 + _randn(gen, C, scale=0.2), _randn(gen, C, scale=0.3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("path", ["two_launch", "cluster"])
@pytest.mark.parametrize("B,H,W,C,G", [(3, 19, 23, 144, 24), (2, 24, 24, 528, 24),
                                       (1, 17, 9, 20, 5)])
def test_gn_kernel_paths_match_plain(cuda, dtype, tol, path, B, H, W, C, G):
    """Both designs at the same shapes: the statistics + apply launches and
    the one cluster launch (8 blocks per image), odd H and W, C = 20
    on the one-element vector path."""
    gen = torch.Generator(device=cuda).manual_seed(C + B)
    x, gamma, beta = _gn_case(gen, B, H, W, C, dtype)
    plan = gn_plan(B, H * W, C, G, x.element_size(), cluster=CLUSTER if path == "cluster" else 0)
    assert plan["path"] == path
    got = group_norm_silu_cuda(x, gamma, beta, G, plan=plan)
    torch.cuda.synchronize()
    want = group_norm_silu_plain(x, gamma, beta, G)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(group_norm_silu_cuda(x, gamma, beta, G, plan=plan), got)


def test_gn_calls_share_one_scratch(cuda):
    """Two-launch calls of different batch sizes and shapes, and statistics
    launches between them, on one stream's scratch: each call's tickets
    start at zero."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for B, H, C, G in ((3, 20, 144, 24), (2, 24, 528, 24), (5, 16, 64, 32), (2, 24, 528, 24)):
        x, gamma, beta = _gn_case(gen, B, H, H + 3, C, torch.float32)
        plan = gn_plan(B, H * (H + 3), C, G, 4, cluster=0)
        got = group_norm_silu_cuda(x, gamma, beta, G, plan=plan)
        gn_channel_affine(x, gamma, beta, G)
        want = group_norm_silu_plain(x, gamma, beta, G)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# the outputs are fp32 in both versions, from the same inputs: summation order only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("C,G", [(144, 24), (272, 17), (528, 24), (64, 32), (20, 5)])
def test_gn_affine_kernel_matches_plain(cuda, dtype, B, C, G):
    """gn_channel_affine's statistics kernel: groups of 6, 16, 22 and 4
    channels, C = 20 on the one-element path in bf16, odd H and W."""
    gen = torch.Generator(device=cuda).manual_seed(C + B)
    x, gamma, beta = _gn_case(gen, B, 19, 23, C, dtype)
    before = gn_channel_affine.launches
    scale, shift = gn_channel_affine(x, gamma, beta, G)
    torch.cuda.synchronize()
    assert gn_channel_affine.launches == before + 1
    want = gn_channel_affine_plain(x, gamma, beta, G)
    for got, w in zip((scale, shift), want):
        assert got.dtype == torch.float32 and got.shape == (B, C)
        torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_kernels_repeat_bit_for_bit(cuda, dtype):
    """Many statistics blocks per image, folded by whichever block takes the
    last ticket, and the cluster's DSMEM fold: the same inputs give the same
    bits on every call."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, gamma, beta = _gn_case(gen, 8, 32, 32, 256, dtype)
    a = gn_channel_affine(x, gamma, beta, 32)
    for _ in range(3):
        b = gn_channel_affine(x, gamma, beta, 32)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for cluster in (0, CLUSTER):
        plan = gn_plan(8, 32 * 32, 256, 32, x.element_size(), cluster=cluster)
        y = group_norm_silu_cuda(x, gamma, beta, 32, plan=plan)
        for _ in range(3):
            assert torch.equal(group_norm_silu_cuda(x, gamma, beta, 32, plan=plan), y)


def test_gn_plan_matches_kernel_shared_memory(cuda):
    """The Python plan's shared-memory counts are the kernels' own."""
    lib = _build.load("group_norm_silu")
    for C, G in ((64, 32), (144, 24), (528, 24), (20, 5), (2048, 32)):
        for vec, tsize in ((8, 2), (4, 4), (1, 2)):
            if C % vec:
                continue
            assert lib.gns_smem_bytes(0, C, G, vec, 0, tsize) == stats_smem_bytes(C, G, vec)
            for rows in (64, 257):
                assert lib.gns_smem_bytes(1, C, G, vec, rows, tsize) == cluster_smem_bytes(
                    rows, C, G, vec, tsize)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="D=64"):
        flash_attention(q, q, q)
    x = torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.float16)
    s = torch.zeros(1, 8, device=cuda)
    with pytest.raises(TypeError):
        fused_gn_silu_conv3x3(x, s, s, torch.zeros(3, 3, 8, 8, device=cuda), s)
    g = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        group_norm_silu(x, g, g, 4)
    x32 = x.float()
    with pytest.raises(ValueError, match="groups"):
        group_norm_silu(x32, g, g, 3)
    with pytest.raises(ValueError, match=r"\[C\]"):
        group_norm_silu(x32, g[:4], g[:4], 4)
    with pytest.raises(ValueError, match="devices"):
        group_norm_silu(x32, g.cpu(), g.cpu(), 4)
    with pytest.raises(TypeError):
        gn_channel_affine(x, g, g, 4)
    with pytest.raises(ValueError, match="groups"):
        gn_channel_affine(x32, g, g, 3)
    with pytest.raises(ValueError, match="devices"):
        gn_channel_affine(x32, g.cpu(), g, 4)
