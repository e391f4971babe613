"""The port's CUDA kernels against their plain PyTorch versions, and the
compiled sampler (one CUDA graph per sampler step) against the eager loop,
on the card.

Every test here needs a CUDA card and skips without one: the kernels have no
CPU mode. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from instancediff_torch.models.clip_vit import CLIPVisionTower, image_context
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.engine import kernel_launches
from instancediff_torch.models.layers import ConvParams
from instancediff_torch.ops.flash_attention import (HEAD_WIDTHS, flash_attention,
                                                     flash_attention_plain, flash_plan)
from instancediff_torch.ops import _build
from instancediff_torch.ops.fused_gn_conv import (
    fused_gn_silu_conv3x3,
    fused_gn_silu_conv3x3_plain,
    gn_channel_affine,
    gn_channel_affine_plain,
    conv_plan,
    tc_smem_bytes,
    tf32_smem_bytes,
)
from instancediff_torch.ops.group_norm_silu import (
    CLUSTER,
    cluster_smem_bytes,
    gn_apply,
    gn_apply_plain,
    gn_partial_sums,
    gn_partial_sums_plain,
    gn_plan,
    group_norm_silu,
    group_norm_silu_cuda,
    group_norm_silu_plain,
    stats_smem_bytes,
)
from instancediff_torch.sde import DDPMSDE, DriftSDE, strided_sampling_grid
from instancediff_torch.serving import Restorer

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
    for D in (8, 64, 96, 128):
        q, k, v = (_randn(gen, 2, 4, 784, D).to(dtype) for _ in range(3))
        assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


def test_conv_plan_matches_kernel_shared_memory(cuda):
    """The Python plan's shared-memory count is the kernel's own."""
    lib = _build.load("fused_gn_silu_conv3x3")
    for th in (8, 16):
        for nb in (8, 64, 128, 256):
            for stages in (2, 4):
                assert lib.fgc_tc_smem_bytes(th, nb, stages) == tc_smem_bytes(th, nb, stages)


def test_fp32_conv_plan_matches_kernel_shared_memory(cuda):
    """The fp32 plan's shared-memory count is the split-TF32 kernel's own."""
    lib = _build.load("fused_gn_silu_conv3x3")
    for nb in (8, 16, 32, 64, 128):
        assert lib.fgc_tf32_smem_bytes(nb) == tf32_smem_bytes(nb)


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


# the sharded GroupNorm's entries: fp32 sums of the same inputs (summation
# order only); the apply's output rounded to x's dtype once, as the plain
# version rounds it (bf16: one ulp where the fp32 values straddle a boundary)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,W,C", [(1, 19, 23, 144), (3, 8, 64, 528), (2, 17, 9, 20),
                                     (2, 128, 256, 64)])
def test_gn_sharded_entries_match_plain(cuda, dtype, tol, B, H, W, C):
    """``gn_partial_sums`` (per-(B,C) sum and sum of squares) and
    ``gn_apply`` (x * scale + shift, with and without SiLU) against their
    plain versions: odd H and W, C = 20 on the one-element path in bf16, a
    half-height flagship slab; both repeat bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(C + B)
    x = (0.5 + _randn(gen, B, H, W, C)).to(dtype)
    before = gn_partial_sums.launches
    sums = gn_partial_sums(x)
    torch.cuda.synchronize()
    assert gn_partial_sums.launches == before + 1
    want = gn_partial_sums_plain(x)
    assert sums.dtype == torch.float32 and sums.shape == (2, B, C)
    torch.testing.assert_close(sums, want, rtol=1e-4, atol=1e-4 * H * W)
    assert torch.equal(gn_partial_sums(x), sums)
    scale, shift = 1 + _randn(gen, B, C, scale=0.2), _randn(gen, B, C, scale=0.3)
    for silu in (True, False):
        before = gn_apply.launches
        got = gn_apply(x, scale, shift, silu)
        torch.cuda.synchronize()
        assert gn_apply.launches == before + 1 and got.dtype == dtype and got.shape == x.shape
        torch.testing.assert_close(got.float(), gn_apply_plain(x, scale, shift, silu).float(),
                                   rtol=tol, atol=tol)
        assert torch.equal(gn_apply(x, scale, shift, silu), got)


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
    q = torch.zeros(1, 2, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="D=48"):
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


# ---------------------------------------------------------------- the compiled sampler

# a tiny UNet whose bottleneck self-attention has the flash kernel's head
# width (256 channels, 4 heads of 64), at 32 px; the tiny text tower; T=10
GRAPH_NET = dict(in_nc=2, out_nc=5, nf=64, ch_mult=[1, 4], context_dim=32,
                 text_module="scoremap", score_map_chan=4, score_map_ngf=8, num_res_blocks=1)
GRAPH_T, GRAPH_RES, GRAPH_B = 10, 32, 2
GRAPH_PATHS = ("drift", "drift_unfused", "ddpm")


def _randomize_(module, seed):
    """Seeded random values for every parameter (conv2, conv_out and the
    attention out projections start at zero, which would hide branches)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            r = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                r = r * (p.numel() / max(p.shape)) ** -0.5
            elif name.endswith("weight"):
                r = 1 + 0.1 * r
            else:
                r = 0.1 * r
            p.copy_(r)


def _graph_engine(path, dtype):
    if path == "ddpm":
        eng = CLIPDDPMEngine(GRAPH_NET, sde=DDPMSDE(T=GRAPH_T), dtype=dtype,
                             tiny_text_encoder=True, device="cuda")
    else:
        eng = CLIPDriftEngine(
            GRAPH_NET, GRAPH_NET, score_map_ch_mult=(1, 1), score_map_ngf=8,
            sde=DriftSDE(T=GRAPH_T, max_sigma=0.4), dtype=dtype, tiny_text_encoder=True,
            engine_opts={"fused_gnconv": path == "drift"}, device="cuda")
    _randomize_(eng.nets, seed=1)
    _randomize_(eng.text_encoder, seed=2)
    return eng


def _graph_batch(seed):
    rng = np.random.default_rng(seed)
    return {"input": rng.uniform(-1, 1, (GRAPH_B, GRAPH_RES, GRAPH_RES, 1)).astype(np.float32),
            "type_idx": rng.integers(0, 5, GRAPH_B),
            "A_emb": rng.standard_normal((GRAPH_B, 1, 32)).astype(np.float32)}


@pytest.fixture
def deterministic(cuda):
    """cuDNN's default algorithm for the decoder's transposed convs sums with
    atomics in fp32: the eager loop differs from itself by up to ~4e-6 per
    UNet forward. Graph against eager compares the capture, so every op is
    held to a deterministic algorithm (then the two are bit-identical)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = before


def _assert_graph_matches_eager(got, want, dtype):
    """fp32: the same kernels on the same inputs, 1e-5 abs; bf16: TOL 1e-2
    relative to the largest output, as chip_smoke.py holds the flagship."""
    limit = 1e-5 if dtype == torch.float32 else 1e-2 * max(1.0, want.abs().max().item())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= limit


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_matches_eager(deterministic, path, dtype, eta):
    """A request of 3 strided steps of T=10 (each step its own coefficients)
    replayed from the captured step against the eager loop, same generator
    seed; the launches per step recorded at capture are the eager loop's,
    and the compiled call counts the warm-up step's launches and each
    replay's."""
    eng = _graph_engine(path, dtype)
    batch = _graph_batch(0)
    n_steps = len(strided_sampling_grid(GRAPH_T, 3)[0])
    before = kernel_launches()
    want = eng.test(batch, torch.Generator(device="cuda").manual_seed(7), sample_steps=3,
                    eta=eta, compiled=False)
    eager = {k: v - before[k] for k, v in kernel_launches().items()}
    before = kernel_launches()
    got = eng.test(batch, torch.Generator(device="cuda").manual_seed(7), sample_steps=3, eta=eta)
    torch.cuda.synchronize()
    compiled = {k: v - before[k] for k, v in kernel_launches().items()}
    assert eng.captures == 1 and len(eng.graphs) == 1
    entry = next(iter(eng.graphs.values()))
    assert eng.last_graph is entry and entry.replays == n_steps and entry.calls == 1
    assert {k: v * n_steps for k, v in entry.launches.items()} == eager
    assert {k: v * (n_steps + 1) for k, v in entry.launches.items()} == compiled
    assert entry.launches["flash_attention"] == (1 if path == "ddpm" else 2)
    assert (entry.launches["fused_gn_silu_conv3x3"] > 0) == (path == "drift")
    assert (entry.launches["group_norm_silu"] > 0) == (path != "drift")
    _assert_graph_matches_eager(got, want, dtype)
    if path == "drift" and dtype == torch.bfloat16:  # packed in the warm-up, not per replay
        assert all(hasattr(m.weight, "_fgc_packed") for m in eng.nets["d_ema"].modules()
                   if isinstance(m, ConvParams))


def test_graph_is_reused_and_recaptured_per_key(cuda):
    """A second call of the same key copies its own inputs into the graph's
    buffers and replays it (no capture); injected noise is honoured; a
    padded Restorer request replays the same graph; a new sample_steps
    captures anew, into the same memory pool."""
    eng = _graph_engine("drift", torch.bfloat16)
    gen = torch.Generator(device=cuda)
    eng.test(_graph_batch(0), gen.manual_seed(1), sample_steps=2)
    batch = _graph_batch(1)
    got = eng.test(batch, gen.manual_seed(2), sample_steps=2)
    want = eng.test(batch, gen.manual_seed(2), sample_steps=2, compiled=False)
    _assert_graph_matches_eager(got, want, torch.bfloat16)
    assert eng.captures == 1 and len(eng.graphs) == 1
    entry = next(iter(eng.graphs.values()))
    assert entry.calls == 2 and entry.replays == 4
    noise = torch.randn(3, GRAPH_B, GRAPH_RES, GRAPH_RES, 1, generator=gen.manual_seed(3),
                        device=cuda)
    got = eng.test(batch, sample_steps=2, init_noise=noise[0], step_noise=noise[1:])
    want = eng.test(batch, sample_steps=2, init_noise=noise[0], step_noise=noise[1:],
                    compiled=False)
    _assert_graph_matches_eager(got, want, torch.bfloat16)
    images = _graph_batch(2)["input"][:1].repeat(3, axis=0)
    out = Restorer(eng, batch_size=GRAPH_B, sample_steps=2, device="cuda").restore(
        images, "speckle in OCT")
    assert out.shape == images.shape and np.isfinite(out).all()
    assert eng.captures == 1 and entry.calls == 5
    eng.test(batch, gen.manual_seed(4), sample_steps=3)
    assert eng.captures == 2 and len(eng.graphs) == 2


@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_is_recaptured_after_an_in_place_weight_update(cuda, path):
    """Weights loaded in place after a capture (``load_engine``'s
    ``copy_``, an EMA step): the next compiled call captures anew and
    matches the eager loop on the new weights; an eager call in between
    repacks the conv weights while the old graph still holds its copies."""
    eng = _graph_engine(path, torch.bfloat16)
    batch = _graph_batch(0)
    eng.test(batch, torch.Generator(device="cuda").manual_seed(1), sample_steps=2)
    old = eng.last_graph
    assert eng.captures == 1 and (len(old.keep) > 0) == (path == "drift")
    _randomize_(eng.nets, seed=5)
    eager = eng.test(batch, torch.Generator(device="cuda").manual_seed(2), sample_steps=2,
                     compiled=False)
    got = eng.test(batch, torch.Generator(device="cuda").manual_seed(2), sample_steps=2)
    assert eng.captures == 2 and len(eng.graphs) == 1 and eng.last_graph is not old
    _assert_graph_matches_eager(got, eager, torch.bfloat16)
    again = eng.test(batch, torch.Generator(device="cuda").manual_seed(2), sample_steps=2)
    assert eng.captures == 2
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_compiled_needs_a_cuda_engine(cuda):
    eng = CLIPDDPMEngine(dict(GRAPH_NET, nf=8, ch_mult=[1, 2]), sde=DDPMSDE(T=GRAPH_T),
                         tiny_text_encoder=True, device="cpu")
    with pytest.raises(ValueError, match="compiled=True captures a CUDA graph"):
        eng.test(_graph_batch(0), compiled=True)


# ---------------------------------------------------------------- bundles


def _graph_engine_like(path, dtype):
    """An engine of ``_graph_engine``'s configuration at PyTorch's init."""
    if path == "ddpm":
        return CLIPDDPMEngine(GRAPH_NET, sde=DDPMSDE(T=GRAPH_T), dtype=dtype,
                              tiny_text_encoder=True, device="cuda")
    return CLIPDriftEngine(GRAPH_NET, GRAPH_NET, score_map_ch_mult=(1, 1), score_map_ngf=8,
                           sde=DriftSDE(T=GRAPH_T, max_sigma=0.4), dtype=dtype,
                           tiny_text_encoder=True,
                           engine_opts={"fused_gnconv": path == "drift"}, device="cuda")


@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_bundle_serves_as_the_engine_it_came_from(cuda, path, tmp_path):
    """bf16: an engine saved (bundle and text sidecar) and loaded into
    another engine on the card, after that engine captured its sampler step
    on its initial weights, answers the same request bit for bit: the load
    made the next call capture anew."""
    eng = _graph_engine(path, torch.bfloat16)
    images = _graph_batch(0)["input"]

    def request(engine):
        return Restorer(engine, batch_size=GRAPH_B, sample_steps=3, seed=4,
                        device="cuda").restore(images, "speckle in OCT")

    want = request(eng)
    eng.save(str(tmp_path), "latest")
    other = _graph_engine_like(path, torch.bfloat16)
    stale = request(other)
    other.load(str(tmp_path), "latest")
    assert other.text_weights == "sidecar" and other.captures == 1
    got = request(other)
    assert other.captures == 2 and not np.array_equal(stale, want)
    np.testing.assert_array_equal(got, want)


def test_from_config_on_cuda(deterministic, tmp_path):
    """``Restorer.from_config`` serves a saved bundle on the card, on the
    compiled sampler, as the engine that saved it (fp32, cuDNN held
    deterministic: bit for bit)."""
    import yaml

    eng = _graph_engine("drift", torch.float32)
    models = tmp_path / "models"
    eng.save(str(models), 3)
    net = dict(GRAPH_NET, if_MultiScoreMap=True)
    opt = {"resolution": GRAPH_RES, "train": {"which_model": "DriftNoise",
                                              "which_sde": "driftSDE"},
           "test": {"pth_dir": str(models), "iter": 3},
           "models": {"DriftNoise": {"module_name": "drift_noise_model",
                                     "class_name": "CLIPDriftModel", "dnet_settings": net,
                                     "nnet_settings": net, "score_map_ch_mult": [1, 1],
                                     "score_map_ngf": 8, "tiny_text_encoder": True}},
           "sdes": {"driftSDE": {"class_name": "driftSDE", "T": GRAPH_T, "max_sigma": 0.4}}}
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump(opt))
    r = Restorer.from_config(str(cfg), iteration=3, batch_size=GRAPH_B, sample_steps=2, seed=1)
    assert r.engine.device.type == "cuda" and r.engine.text_weights == "sidecar"
    images = _graph_batch(1)["input"]
    got = r.restore(images, "Gaussian noise in MRI")
    want = Restorer(eng, batch_size=GRAPH_B, sample_steps=2, seed=1, device="cuda").restore(
        images, "Gaussian noise in MRI")
    assert r.engine.captures == 1 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_msgpack_codec_on_a_cuda_bf16_tensor(cuda):
    from instancediff_torch.utils import msgpack

    t = torch.randn(5, 33, device=cuda).to(torch.bfloat16)
    data = msgpack.to_bytes({"w": t, "n": 3})
    assert data == msgpack.to_bytes({"w": t.cpu(), "n": 3})
    back = msgpack.from_bytes(data)
    assert back["n"] == 3 and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t.cpu())


# ---------------------------------------------------------------- training


def _train_engine(path, dtype):
    """A trainable engine at the graph tests' widths, seeded."""
    kw = dict(sde=(DDPMSDE(T=GRAPH_T) if path == "ddpm" else DriftSDE(T=GRAPH_T, max_sigma=0.4)),
              dtype=dtype, tiny_text_encoder=True, device="cuda", if_train=True,
              image_size=GRAPH_RES, noise_net_lr=1e-3)
    if path == "ddpm":
        eng = CLIPDDPMEngine(GRAPH_NET, **kw)
    else:
        eng = CLIPDriftEngine(GRAPH_NET, GRAPH_NET, score_map_ch_mult=(1, 1), score_map_ngf=8,
                              drift_net_lr=1e-3, **kw)
    _randomize_(eng.nets, seed=1)
    _randomize_(eng.text_encoder, seed=2)
    return eng


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    batch = _graph_batch(seed)
    batch["target"] = rng.uniform(-1, 1, batch["input"].shape).astype(np.float32)
    return batch


def test_kernel_wrappers_refuse_autograd(cuda):
    """A kernel's output has no autograd history: each wrapper raises when
    gradients are on and an input requires grad, and runs under no_grad."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = _randn(gen, 2, 8, 8, 64).requires_grad_()
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    s = torch.ones(2, 64, device=cuda)
    w = _randn(gen, 3, 3, 64, 64, scale=0.1)
    q = _randn(gen, 2, 4, 16, 64).requires_grad_()
    calls = {"fused_gn_silu_conv3x3": lambda: fused_gn_silu_conv3x3(x, s, s, w, s),
             "gn_channel_affine": lambda: gn_channel_affine(x, g, b, 32),
             "group_norm_silu": lambda: group_norm_silu(x, g, b, 32),
             "flash_attention": lambda: flash_attention(q, q, q)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["drift", "ddpm"])
def test_train_step_reaches_every_parameter(cuda, path, dtype):
    """A train step on the card launches no kernel and leaves every trained
    parameter a finite gradient that is not all zero (the SMM contexts
    through the frozen text tower too); the key biases, which the softmax
    cancels in exact arithmetic, only finite; parameters and Adam's
    moments stay float32."""
    eng = _train_engine(path, dtype)
    before = kernel_launches()
    loss = eng.optimize_parameters(_train_batch(0), torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert kernel_launches() == before and np.isfinite(loss)
    for key in eng.optimizers:
        for name, p in eng.nets[key].named_parameters():
            assert p.dtype == torch.float32 and p.grad is not None, name
            assert torch.isfinite(p.grad).all(), name
            if not name.endswith(("k_proj.bias", ".k.bias")):
                assert p.grad.abs().max() > 0, name
            st = eng.optimizers[key].state[p]
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
        assert all(c.grad.abs().max() > 0 for c in eng.nets[key].smm_contexts())
    assert not any(p.requires_grad for p in eng.text_encoder.parameters())


@pytest.mark.parametrize("path", ["drift", "ddpm"])
def test_compiled_sampler_recaptures_after_a_train_step(deterministic, path):
    """The sampler's graph reads the nets by address: after
    ``optimize_parameters`` updates them in place the next compiled call
    captures anew, and matches the eager loop on the new weights."""
    eng = _train_engine(path, torch.float32)
    gen = torch.Generator(device="cuda")
    batch = _graph_batch(3)
    for use_ema in (False, True):
        eng.test(batch, gen.manual_seed(1), sample_steps=2, use_ema=use_ema)
    captures = eng.captures
    for step in range(10):  # the EMA ticks at step 10
        eng.optimize_parameters(_train_batch(step), gen.manual_seed(10 + step))
    for use_ema in (False, True):
        got = eng.test(batch, gen.manual_seed(2), sample_steps=2, use_ema=use_ema)
        want = eng.test(batch, gen.manual_seed(2), sample_steps=2, use_ema=use_ema,
                        compiled=False)
        _assert_graph_matches_eager(got, want, torch.float32)
    assert eng.captures == captures + 2


# ---------------------------------------------------------------- the encoders


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_the_image_towers_shape(cuda, dtype, tol):
    """ViT-B/16 at 224 px: 12 heads of 64 over 197 tokens (ragged for the
    tiles)."""
    gen = torch.Generator(device=cuda).manual_seed(197)
    q, k, v = (_randn(gen, 2, 12, 197, 64).to(dtype) for _ in range(3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(), rtol=tol,
                               atol=tol)


def test_image_tower_on_cuda_matches_the_cpu(cuda):
    """A ViT with 64-wide heads (2 layers of width 128, the full tower's
    head width), fp32: its attention on the flash kernel on the card, on the
    plain version on the CPU, within 1e-4; the normalised image context of
    unit norm; 2 flash launches per call."""
    tower = CLIPVisionTower(image_size=64, patch_size=16, width=128, layers=2, heads=2,
                            embed_dim=32)
    _randomize_(tower, seed=3)
    images = torch.rand(3, 64, 64, 1, generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.inference_mode():
        want = tower(images)
        gpu_tower = tower.to(cuda)
        before = flash_attention.launches
        got = gpu_tower(images.to(cuda))
        ctx = image_context(gpu_tower, images.to(cuda))
        torch.cuda.synchronize()
    assert flash_attention.launches == before + 4
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.linalg.vector_norm(ctx, dim=-1).cpu(),
                               torch.ones(3, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", ["drift", "ddpm"])
def test_biomedclip_engine_graph_matches_eager(cuda, path):
    """``CLIP_Type: BiomedCLIP`` (the BERT tower, WordPiece ids and mask):
    the captured step replays bit-identically to the eager loop in bf16;
    a drift engine with a 64-wide-head image tower attached too (the tower
    runs before the graph, 2 flash launches per call)."""
    kw = dict(dtype=torch.bfloat16, tiny_text_encoder=True, CLIP_Type="BiomedCLIP",
              device="cuda")
    if path == "ddpm":
        eng = CLIPDDPMEngine(GRAPH_NET, sde=DDPMSDE(T=GRAPH_T), **kw)
    else:
        eng = CLIPDriftEngine(GRAPH_NET, GRAPH_NET, score_map_ch_mult=(1, 1), score_map_ngf=8,
                              sde=DriftSDE(T=GRAPH_T, max_sigma=0.4), **kw)
        tower = CLIPVisionTower(image_size=GRAPH_RES, patch_size=8, width=128, layers=2,
                                heads=2, embed_dim=32)
        _randomize_(tower, seed=5)
        eng.attach_image_tower(tower)
    _randomize_(eng.nets, seed=1)
    _randomize_(eng.text_encoder, seed=2)
    assert eng.prompt_mask is not None and eng.token_embed_dim == 48
    batch = _graph_batch(0)
    want = eng.test(batch, torch.Generator(device="cuda").manual_seed(7), sample_steps=3,
                    compiled=False)
    before = flash_attention.launches
    got = eng.test(batch, torch.Generator(device="cuda").manual_seed(7), sample_steps=3)
    torch.cuda.synchronize()
    n_steps = len(strided_sampling_grid(GRAPH_T, 3)[0])
    per_step = eng.last_graph.launches["flash_attention"]
    assert eng.captures == 1
    assert flash_attention.launches - before == per_step * (n_steps + 1) + (
        2 if path == "drift" else 0)
    assert torch.equal(got, want)


def test_biomedclip_low_precision_on_cuda(cuda):
    """BiomedCLIP at full width (ViT-B/16, the 12-layer PubMedBERT) on the
    card at precision bf16, pure_bf16, fp16 and pure_fp16, from the same
    random weights as at fp32: unit-norm 16-bit embeddings within 1e-2 of
    the fp32 model's, the tower's 12 flash launches per ``encode_image``
    call (on the fp16 instantiation at fp16); a dtype no kernel takes
    (float64) raises in the wrapper."""
    from instancediff_torch.models.biomedclip import get_BiomedCLIP
    from instancediff_torch.models.text_encoder import HFContextTextEncoder
    from instancediff_torch.utils.convert import flax_params

    visual = CLIPVisionTower()
    text = HFContextTextEncoder()
    _randomize_(visual, seed=6)
    _randomize_(text, seed=7)
    trees = dict(params=flax_params(visual), text_params=flax_params(text))
    images = torch.rand(4, 224, 224, 1, generator=torch.Generator().manual_seed(8)) * 2 - 1
    texts = ["speckle in OCT", "noise in cryo-EM image", "low dose CT"]
    ref = get_BiomedCLIP(precision="fp32", device="cuda", **trees)
    want = ref.encode_image(images), ref.encode_text(texts)
    for precision in ("bf16", "pure_bf16", "fp16", "pure_fp16"):
        low = torch.bfloat16 if "bf16" in precision else torch.float16
        model = get_BiomedCLIP(precision=precision, device="cuda", **trees)
        before = flash_attention.launches
        got = model.encode_image(images), model.encode_text(texts)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 12
        for g, w in zip(got, want):
            assert g.dtype == low and torch.isfinite(g).all()
            torch.testing.assert_close(g.float(), w, rtol=0, atol=1e-2)
    q = torch.zeros(1, 12, 197, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        flash_attention(q, q, q)


# ---------------------------------------------------------------- every head width


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("N", [64, 197, 1024])
@pytest.mark.parametrize("D", HEAD_WIDTHS)
def test_flash_kernel_at_every_head_width(cuda, dtype, tol, N, D):
    """Every head width the kernels take (the UNet bottleneck's 4 heads give
    D = nf * ch_mult[-1] / 4), both dtypes, N one tile, ragged and the
    flagship's; one launch, no plain fallback."""
    gen = torch.Generator(device=cuda).manual_seed(N * 1000 + D)
    q, k, v = (_randn(gen, 2, 4, N, D).to(dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(), rtol=tol,
                               atol=tol)


def _flash_kernel_names(q):
    from torch.profiler import ProfilerActivity, profile

    flash_attention(q, q, q)  # loaded before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, q, q)
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if "flash_" in e.name]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("D", HEAD_WIDTHS)
def test_flash_plan_picks_the_kernel_the_card_runs(cuda, D, dtype):
    """Every (D, dtype) runs a tensor-core kernel, by the profiler's kernel
    name: bf16 and fp16 on ``flash_tc_kernel`` (its ``__half`` instantiation
    for fp16), fp32 on ``flash_tf32x3_kernel``."""
    q = torch.zeros(1, 4, 128, D, device=cuda, dtype=dtype)
    names = _flash_kernel_names(q)
    want = {"tc": "flash_tc_kernel", "tf32x3": "flash_tf32x3_kernel"}[flash_plan(D, dtype)["path"]]
    assert len(names) == 1 and want in names[0], names
    assert (want == "flash_tc_kernel") == (dtype != torch.float32)
    if dtype == torch.float16:
        assert "__half" in names[0], names


@pytest.mark.parametrize("N", [50, 197, 1024])
@pytest.mark.parametrize("D", HEAD_WIDTHS)
def test_flash_fp16_repeats_bit_for_bit(cuda, D, N):
    """The fp16 kernel gives the same bits on a repeat of the same call
    (one launch each, no atomics), at every head width, N of RN50's
    attention pool, the ViT tower and the UNet bottleneck."""
    gen = torch.Generator(device=cuda).manual_seed(7 * N + D)
    q, k, v = (_randn(gen, 2, 4, N, D).half() for _ in range(3))
    before = flash_attention.launches
    a, b = flash_attention(q, k, v), flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert a.dtype == torch.float16 and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,Cout", [(64, 64), (20, 5), (528, 256)])
def test_conv_plan_picks_the_kernel_the_card_runs(cuda, dtype, C, Cout):
    """Both dtypes run a tensor-core kernel, by the profiler's kernel name:
    bf16 on ``fgc_tc_kernel`` (wgmma), fp32 on ``fgc_tf32x3_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(C)
    x, scale, shift, w, bias, _ = _conv_case(gen, 2, 16, 16, C, Cout, False, dtype)
    fused_gn_silu_conv3x3(x, scale, shift, w, bias)  # loaded and packed before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_gn_silu_conv3x3(x, scale, shift, w, bias)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "fgc_" in e.name]
    want = {"tc": "fgc_tc_kernel", "tf32x3": "fgc_tf32x3_kernel"}[
        conv_plan(2, 16, 16, C, Cout, dtype)["kernel"]]
    assert len(names) == 1 and want in names[0], names
    assert (want == "fgc_tc_kernel") == (dtype == torch.bfloat16)


# a tiny engine of the demos' and the distillation gate's widths: nf 16,
# ch_mult [1, 2], so the bottleneck's 4 heads are 8 wide
TINY_NET = dict(in_nc=2, out_nc=5, nf=16, ch_mult=[1, 2], context_dim=16, text_module="scoremap",
                score_map_chan=4, if_MultiScoreMap=True, num_res_blocks=1)


def _tiny_engine(dtype=torch.float32, if_train=False):
    eng = CLIPDriftEngine(TINY_NET, TINY_NET, score_map_ch_mult=(1, 1), score_map_ngf=16,
                          sde=DriftSDE(T=16, max_sigma=0.3), dtype=dtype, tiny_text_encoder=True,
                          image_size=32, device="cuda", if_train=if_train)
    _randomize_(eng.nets, seed=3)
    _randomize_(eng.text_encoder, seed=4)
    return eng


def _tiny_batch(seed, B=4):
    rng = np.random.default_rng(seed)
    return {"input": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
            "target": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
            "type_idx": rng.integers(0, 5, B),
            "A_emb": rng.standard_normal((B, 1, 16)).astype(np.float32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_width_engine_samples_on_the_compiled_sampler(deterministic, dtype):
    """nf 16, ch_mult [1, 2] (8-wide heads): the compiled sampler at 8 of 16
    steps, eta 0, against the eager loop; the kernels recorded per step: 2
    flash, 10 fused conv, 10 statistics (5 ResBlocks and the head per
    net)."""
    eng = _tiny_engine(dtype)
    batch = _tiny_batch(0)
    gen = torch.Generator(device="cuda")
    got = eng.test(batch, gen.manual_seed(1), sample_steps=8, eta=0.0)
    want = eng.test(batch, gen.manual_seed(1), sample_steps=8, eta=0.0, compiled=False)
    _assert_graph_matches_eager(got, want, dtype)
    per_step = eng.last_graph.launches
    assert per_step["flash_attention"] == 2 and per_step["group_norm_silu"] == 0
    assert per_step["fused_gn_silu_conv3x3"] == per_step["gn_channel_affine"] > 0


def test_distill_teacher_targets_on_the_kernels_match_the_plain_path(cuda):
    """The teacher's composed targets with its two predictions on the
    kernels (its sampling path) and with every kernel wrapper patched to its
    plain version: fp32 within 1e-4 of the targets' largest magnitude."""
    from unittest import mock

    from instancediff_torch.models import unet as unet_mod
    from instancediff_torch.models.distill import Teacher, distill_targets
    from instancediff_torch.ops.fused_gn_conv import gn_channel_affine_plain

    eng = _tiny_engine(if_train=True)
    teacher = Teacher.from_engine(eng)
    gen = torch.Generator(device="cuda")
    before = kernel_launches()
    got = distill_targets(eng, teacher, _tiny_batch(1), 8, 1.0, True, generator=gen.manual_seed(5))
    after = kernel_launches()
    assert after["flash_attention"] - before["flash_attention"] == 4
    assert after["fused_gn_silu_conv3x3"] > before["fused_gn_silu_conv3x3"]
    plain = {"fused_gn_silu_conv3x3": fused_gn_silu_conv3x3_plain,
             "gn_channel_affine": gn_channel_affine_plain,
             "group_norm_silu": group_norm_silu_plain, "flash_attention": flash_attention_plain}
    with mock.patch.multiple(unet_mod, **plain):
        want = distill_targets(eng, teacher, _tiny_batch(1), 8, 1.0, True,
                               generator=gen.manual_seed(5))
    for k in ("d_tgt", "n_tgt"):
        err = (got[k] - want[k]).abs().max().item()
        assert err <= 1e-4 * max(1.0, want[k].abs().max().item()), (k, err)


def test_distill_phase_then_test_captures_a_new_graph(cuda):
    """A compiled call before a phase captures the online nets' step; after
    a phase (in-place copies and updates) the next call at the student's
    steps captures anew and serves the student, as the eager loop does."""
    from instancediff_torch.models.distill import distill_phase

    eng = _tiny_engine(if_train=True)
    batch = _tiny_batch(2)
    gen = torch.Generator(device="cuda")
    eng.test(batch, gen.manual_seed(1), sample_steps=8, eta=0.0, use_ema=False)
    captures = eng.captures
    batches = iter([_tiny_batch(10 + i) for i in range(3)])
    distill_phase(eng, 8, batches, 3, lr=1e-3, ema_as_teacher=False, log_every=0,
                  generator=gen.manual_seed(3))
    torch.backends.cudnn.deterministic = True
    try:
        got = eng.test(batch, gen.manual_seed(1), sample_steps=8, eta=0.0, use_ema=False)
        want = eng.test(batch, gen.manual_seed(1), sample_steps=8, eta=0.0, use_ema=False,
                        compiled=False)
    finally:
        torch.backends.cudnn.deterministic = False
    assert eng.captures == captures + 1
    _assert_graph_matches_eager(got, want, torch.float32)


# ---------------------------------------------------------------- IR-SDE, ranks on one card


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("path", ["drift", "ddpm"])
def test_irsde_steps_on_the_kernels_match_plain(deterministic, path, dtype, tol):
    """IR-SDE's reverse SDE and probability-flow loops (T = 10) driven by the
    tiny engine's noise net, on the kernels and on the plain path: the
    same result within ``tol`` of the largest value, one net forward's
    launches per step."""
    from unittest import mock

    from instancediff_torch.models import unet as unet_mod
    from instancediff_torch.sde import IRSDE

    plain_versions = {"fused_gn_silu_conv3x3": fused_gn_silu_conv3x3_plain,
                      "flash_attention": flash_attention_plain,
                      "group_norm_silu": group_norm_silu_plain,
                      "gn_channel_affine": gn_channel_affine_plain}

    eng = _graph_engine(path, dtype)
    inputs = eng._inputs(_graph_batch(3), use_ema=True)
    text = inputs["text"] if path == "ddpm" else inputs["n_text"]
    mu, net = inputs["mu"], eng.nets["n_ema"]

    def noise_fn(x, t):
        return net(x, mu, t, inputs["type_idx"], text, inputs["img_ctx"])[0]

    sde = IRSDE(T=10)
    gen = torch.Generator(device="cuda").manual_seed(4)
    init = torch.randn(mu.shape, generator=gen, device="cuda")
    steps = list(torch.randn((10,) + tuple(mu.shape), generator=gen, device="cuda"))
    out = {}
    with torch.inference_mode():
        for plain in (False, True):
            patches = [mock.patch.object(unet_mod, name, fn)
                       for name, fn in plain_versions.items()] if plain else []
            for p in patches:
                p.start()
            try:
                before = kernel_launches()
                x = sde.reverse_sde(mu, noise_fn, init_noise=init, step_noise=steps)
                y = sde.reverse_ode(mu, noise_fn, init_noise=init)
                after = kernel_launches()
            finally:
                for p in patches:
                    p.stop()
            out[plain] = (x, y, {k: after[k] - before[k] for k in after})
    launches = out[False][2]
    assert launches["flash_attention"] == 20 and not any(out[True][2].values())
    body = "fused_gn_silu_conv3x3" if path == "drift" else "group_norm_silu"
    assert launches[body] > 0 and launches[body] % 20 == 0
    for got, want in zip(out[False][:2], out[True][:2]):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def test_two_ranks_share_one_card_over_gloo(cuda):
    """Two spawned ranks on cuda:0 over gloo: the gradient average and the
    weight broadcast on CUDA tensors (NCCL takes one rank per card)."""
    import torch_dist_workers as workers

    ranks = workers.run_world(workers.cuda_gloo_rank, 2)
    for r in ranks:
        assert r["device"] == "cuda:0" and r["bytes"] == (15 + 7) * 4
        np.testing.assert_array_equal(r["mean"][0], np.full((5, 3), 1.5, np.float32))
        np.testing.assert_array_equal(r["mean"][1], np.arange(7.0, dtype=np.float32) * 1.5)
        assert all(not p.any() for p in r["net"])


# ---------------------------------------------------------------- the SMM-less UNet, tracing


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("H,W,C,Cout", [(64, 64, 128, 64), (32, 32, 256, 128),
                                        (16, 16, 512, 256), (8, 8, 512, 256)])
def test_fused_conv_at_the_smm_less_widths(cuda, dtype, tol, H, W, C, Cout):
    """The SMM-less UNet's first decoder convs, whose inputs lose the 16
    score-map channels (144 -> 128, 272 -> 256, 528 -> 512), at batch 2."""
    gen = torch.Generator(device=cuda).manual_seed(C + H)
    x, scale, shift, w, bias, _ = _conv_case(gen, 2, H, W, C, Cout, False, dtype)
    got = fused_gn_silu_conv3x3(x, scale, shift, w, bias)
    torch.cuda.synchronize()
    want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


SMM_LESS_NET = dict(GRAPH_NET, text_module="none", use_image_context=True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("fused", [True, False], ids=["fused_body", "unfused_body"])
def test_smm_less_unet_kernels_match_plain(cuda, dtype, tol, fused):
    """``create_net`` with ``text_module: none`` at the graph tests' widths:
    the forward through the kernels against the plain versions, and the
    launches per forward (a fused conv and a statistics launch per conv, or
    a GroupNorm per conv, and the bottleneck's flash)."""
    from unittest import mock

    from instancediff_torch.models import unet as unet_mod
    from instancediff_torch.models.modules import create_net

    net = create_net(SMM_LESS_NET, dtype=dtype, device=cuda, use_fused_gnconv=fused)
    _randomize_(net, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    B, R = GRAPH_B, GRAPH_RES
    args = (_randn(gen, B, R, R, 1), _randn(gen, B, R, R, 1), torch.full((B,), 5, device=cuda),
            torch.tensor([0, 3], device=cuda), None, _randn(gen, B, 1, 32))
    before = kernel_launches()
    with torch.inference_mode():
        got = net(*args)
        torch.cuda.synchronize()
        after = kernel_launches()
        with mock.patch.object(unet_mod, "fused_gn_silu_conv3x3", fused_gn_silu_conv3x3_plain), \
                mock.patch.object(unet_mod, "gn_channel_affine", gn_channel_affine_plain), \
                mock.patch.object(unet_mod, "group_norm_silu", group_norm_silu_plain), \
                mock.patch.object(unet_mod, "flash_attention", flash_attention_plain):
            want = net(*args)
    assert got.shape == (B, R, R, 1) and torch.isfinite(got).all()
    n_convs = 2 * sum(isinstance(m, unet_mod.ResBlock) for m in net.modules()) + 1  # and the head
    launched = {k: after[k] - before[k] for k in after}
    assert launched == {"fused_gn_silu_conv3x3": n_convs if fused else 0,
                        "gn_channel_affine": n_convs if fused else 0,
                        "group_norm_silu": 0 if fused else n_convs, "flash_attention": 1}
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


def test_tracing_sees_the_kernels(cuda, tmp_path):
    """``utils.tracing.trace`` around a compiled drift request: the exported
    Chrome trace holds the annotation and every replayed kernel by name, as
    many times as the steps ran them; the device's memory statistics."""
    import json

    from instancediff_torch.utils import tracing

    eng = _graph_engine("drift", torch.bfloat16)
    batch = _graph_batch(5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    eng.test(batch, gen, sample_steps=4)  # captures the step
    per_step = eng.last_graph.launches
    with tracing.trace(str(tmp_path)), tracing.annotate("request"):
        eng.test(batch, gen, sample_steps=4)
    with open(tmp_path / tracing.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    steps = len(strided_sampling_grid(GRAPH_T, 4)[0])
    for name, wrapper in (("fgc_tc_kernel", "fused_gn_silu_conv3x3"),
                          ("gns_affine_kernel", "gn_channel_affine"),
                          ("flash_tc_kernel", "flash_attention")):
        assert sum(name in k for k in kernels) == steps * per_step[wrapper] > 0, name
    assert any(e.get("name") == "request" for e in events)
    stats = tracing.device_memory_stats()["cuda:0"]
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"] <= stats["bytes_limit"]


@pytest.mark.parametrize("embed", [64, 768], ids=["pool_d8", "pool_d96"])
def test_coca_on_cuda_matches_the_cpu(cuda, embed):
    """A CoCa whose heads the kernel takes (vision width 128 in 2 heads of
    64; the pooler's 8 heads 8 wide at embed 64, or 96 wide at embed 768,
    as coca_ViT-L-14's; the text and decoder widths the embedding's, in
    heads 16 or 64 wide), fp32: the
    forward on the card (its unmasked attention on the flash kernel: 2 + 1
    per ``encode_image``, 2 per decoder pass) against the CPU's plain
    version within 1e-4; greedy captions equal; beam search runs."""
    from instancediff_torch.models import coca

    heads = 4 if embed == 64 else 12
    model = coca.CoCa(embed_dim=embed, vocab_size=96, context_length=12, text_width=embed,
                      text_heads=heads, text_layers=2, mm_width=embed, mm_heads=heads,
                      mm_layers=2, image_size=64, patch_size=16, vision_width=128,
                      vision_layers=2, vision_heads=2, n_queries=9)
    _randomize_(model, seed=5)
    images = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(6)) * 2 - 1
    ids = torch.tensor([[1, 5, 9, 3, 0, 0], [1, 7, 2, 8, 4, 6]])
    kw = dict(seq_len=8, min_seq_len=2, sot_token_id=1, eos_token_id=2, pad_token_id=0)
    with torch.inference_mode():
        want = model(images, ids)
        greedy = coca.generate(model, images, torch.Generator(), **kw)
        model.to(cuda)
        before = flash_attention.launches
        got = model(images.to(cuda), ids.to(cuda))
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 2 + 1 + 2
        on_card = coca.generate(model, images.to(cuda), torch.Generator(device=cuda), **kw)
        assert torch.equal(on_card.cpu(), greedy)
        beams = coca.generate(model, images.to(cuda), generation_type="beam_search",
                              num_beams=4, num_beam_groups=2, **kw)
    assert beams.shape == (2, 8) and (beams[:, 0] == 1).all()
    for k in ("image_features", "text_features", "logits"):
        scale = max(1.0, want[k].abs().max().item())
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4 * scale)
