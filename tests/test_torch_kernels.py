"""The port's kernel modules and layers against the JAX package on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version, which is held
here against the Pallas kernel in interpret mode (or its jnp reference).
The hand-written CUDA kernels are held against the same plain versions on
the card in ``test_torch_gpu.py``. The parity
traps of the port (flax ``SAME`` padding, the unflipped ConvTranspose
kernel, flax's norm epsilons, the tanh GELU) each have a case that fails if
the trap is mishandled. Last, the guards: the package imports no JAX, and
its entry points refuse to run without CUDA unless asked for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from instancediff_tpu.models.scoremap import ScaledDecoderLayer as JaxDecoderLayer
from instancediff_tpu.models.unet import SelfAttention2D as JaxSelfAttention2D
from instancediff_tpu.ops import pallas_kernels as pk
from instancediff_tpu.ops.attention import multi_head_attention as jax_mha

from instancediff_torch.models.layers import conv_same, conv_transpose_same
from instancediff_torch.models.scoremap import ScaledDecoderLayer
from instancediff_torch.models.unet import SelfAttention2D
from instancediff_torch.ops.attention import multi_head_attention
from instancediff_torch.ops.flash_attention import (HEAD_WIDTHS, flash_attention,
                                                     flash_attention_plain, flash_plan)
from instancediff_torch.ops.fused_gn_conv import (
    fused_gn_silu_conv3x3,
    fused_gn_silu_conv3x3_plain,
    gn_channel_affine,
)
from instancediff_torch.ops.group_norm_silu import group_norm_silu
from instancediff_torch.utils.convert import load_flax_params

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------------------- #
# kernel 2: flash attention                                                    #
# --------------------------------------------------------------------------- #


def test_flash_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 2, 2, 64, 16) for _ in range(3))
    want = np.asarray(pk.flash_attention(q, k, v, q_tile=32, kv_tile=32, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v))  # CPU tensor -> plain version
    # float32; blockwise vs one-shot softmax: rounding only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [4, 8, 128, 96])
def test_flash_plain_matches_pallas_interpret_at_other_head_widths(D):
    """The widths the repo's other configurations give the bottleneck's 4
    heads (tiny_cpu.yml 4, the demos 8, nf 128 128) and coca_ViT-L-14's
    attentional pooler (96, its queries fewer than its keys): JAX's Pallas
    kernel takes any D, and so does the port's plain version."""
    rng = np.random.default_rng(D)
    q = _rand(rng, 2, 4, 64, D)
    k, v = (_rand(rng, 2, 4, 96 if D == 96 else 64, D) for _ in range(2))
    want = np.asarray(pk.flash_attention(q, k, v, q_tile=32, kv_tile=32, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_flash_plan_per_head_width_and_dtype(dtype):
    """A tensor-core kernel at every width they are instantiated for: "tc"
    for bf16 and fp16 (one template over the 16-bit type), "tf32x3" (split
    TF32) for fp32; a named refusal elsewhere (float64 has no kernel)."""
    for D in HEAD_WIDTHS:
        plan = flash_plan(D, dtype)
        assert plan["path"] == ("tf32x3" if dtype == torch.float32 else "tc")
        assert plan["D"] == D
    assert HEAD_WIDTHS == (4, 8, 16, 32, 64, 96, 128)
    for D in (1, 2, 12, 48, 80, 256):
        with pytest.raises(ValueError, match=f"D={D}"):
            flash_plan(D, dtype)
    with pytest.raises(TypeError, match="float64"):
        flash_plan(64, torch.float64)


@pytest.mark.parametrize("N,warps", [(1024, 8), (197, 8), (200, 8), (257, 4), (784, 8), (64, 4)])
def test_flash_plan_warps_follow_n(N, warps):
    """The fp32 kernel runs 8 warps (128 query rows) per block unless 64-row
    blocks pad N to over a tenth fewer rows; the bf16 kernel always runs 8."""
    assert flash_plan(64, torch.float32, N)["warps"] == warps
    assert flash_plan(64, torch.bfloat16, N)["warps"] == 8


def test_flash_plain_ragged_n_matches_reference():
    """N = 40 is ragged for a 32-tile: the Pallas wrapper falls back to its
    reference there; the port's kernel masks instead (checked on the card)."""
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 1, 4, 40, 16) for _ in range(3))
    want = np.asarray(pk.flash_attention_reference(q, k, v))
    got = flash_attention_plain(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_attention_with_mask_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 6, 16), _rand(rng, 2, 6, 16), _rand(rng, 2, 6, 16)
    mask = np.where(np.tril(np.ones((6, 6), bool)), 0.0, -np.inf)[None].astype(np.float32)
    want = np.asarray(jax_mha(q, k, v, 4, mask=mask))
    got = multi_head_attention(_t(q), _t(k), _t(v), 4, mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# kernel 3: fused GN-affine + SiLU + conv3x3                                   #
# --------------------------------------------------------------------------- #


def _fgc_inputs(rng, B, H, W, C, Cout, residual):
    x = _rand(rng, B, H, W, C)
    scale = (1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32)
    shift = _rand(rng, B, C, scale=0.3)
    w = _rand(rng, 3, 3, C, Cout, scale=(9 * C) ** -0.5)
    bias = _rand(rng, B, Cout, scale=0.1)
    res = _rand(rng, B, H, W, Cout) if residual else None
    return x, scale, shift, w, bias, res


@pytest.mark.parametrize("C,Cout,residual", [(20, 5, False), (20, 8, True), (16, 16, True)])
def test_fused_conv_plain_matches_pallas_interpret(C, Cout, residual):
    """Ragged C = 20, the Cout = 5 output head, with and without residual."""
    rng = np.random.default_rng(C + Cout)
    x, scale, shift, w, bias, res = _fgc_inputs(rng, 2, 8, 6, C, Cout, residual)
    want = np.asarray(pk.fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res,
                                               row_tile=4, interpret=True))
    got = fused_gn_silu_conv3x3(_t(x), _t(scale), _t(shift), _t(w), _t(bias),
                                residual=None if res is None else _t(res))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_conv_plain_bf16_matches_reference():
    """bf16: the activation is rounded to bf16 before the conv and the result
    stored in bf16, as in the jnp reference; one bf16 ulp of tolerance."""
    rng = np.random.default_rng(7)
    x, scale, shift, w, bias, res = _fgc_inputs(rng, 2, 8, 8, 24, 16, True)
    xb = jnp.asarray(x, jnp.bfloat16)
    rb = jnp.asarray(res, jnp.bfloat16)
    want = np.asarray(pk.fused_gn_silu_conv3x3_reference(xb, scale, shift, w, bias,
                                                         residual=rb), np.float32)
    got = fused_gn_silu_conv3x3_plain(_t(x).bfloat16(), _t(scale), _t(shift), _t(w),
                                      _t(bias), residual=_t(res).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


def test_gn_channel_affine_matches_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 8, 36) + 0.5
    gamma, beta = 1 + _rand(rng, 36, scale=0.1), _rand(rng, 36, scale=0.1)
    want = pk.gn_channel_affine(x, gamma, beta, 18)
    got = gn_channel_affine(_t(x), _t(gamma), _t(beta), 18)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_do_not_count_launches():
    wrappers = (fused_gn_silu_conv3x3, flash_attention, group_norm_silu, gn_channel_affine)
    before = [f.launches for f in wrappers]
    rng = np.random.default_rng(4)
    x, scale, shift, w, bias, _ = _fgc_inputs(rng, 1, 4, 4, 8, 8, False)
    fused_gn_silu_conv3x3(_t(x), _t(scale), _t(shift), _t(w), _t(bias))
    q = _t(_rand(rng, 1, 1, 8, 4))
    flash_attention(q, q, q)
    group_norm_silu(_t(x), _t(scale[0]), _t(shift[0]), 4)
    gn_channel_affine(_t(x), _t(scale[0]), _t(shift[0]), 4)
    assert [f.launches for f in wrappers] == before


# --------------------------------------------------------------------------- #
# parity traps                                                                 #
# --------------------------------------------------------------------------- #


def test_down_conv_uses_flax_same_padding():
    """A stride-2 SAME conv on an even size pads (0, 1); torch's padding=1
    pads (1, 1) and shifts every output by one input pixel."""
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 8, 8, 3)
    mod = fnn.Conv(4, (3, 3), strides=(2, 2))
    params = jax.tree.map(np.asarray, mod.init(jax.random.key(0), x))
    want = np.asarray(mod.apply(params, x))
    conv = load_flax_params(torch.nn.Conv2d(3, 4, 3), params)
    with torch.no_grad():
        got = conv_same(_t(x), conv, stride=2)
        naive = F.conv2d(_t(x).permute(0, 3, 1, 2), conv.weight, conv.bias, stride=2,
                         padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(naive.numpy() - want).max() > 1e-2


def test_up_conv_is_unflipped_flax_conv_transpose():
    """flax ConvTranspose (k4, s2, SAME) correlates with the unflipped
    kernel, padded (2, 2); the converter flips it for torch."""
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 6, 3)
    mod = fnn.ConvTranspose(4, (4, 4), strides=(2, 2))
    params = {"params": {"kernel": _rand(rng, 4, 4, 3, 4), "bias": _rand(rng, 4)}}
    want = np.asarray(mod.apply(params, x))
    up = load_flax_params(torch.nn.ConvTranspose2d(3, 4, 4), params)
    got = conv_transpose_same(_t(x), up)
    assert got.shape == (2, 10, 12, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    unflipped = _t(params["params"]["kernel"]).permute(2, 3, 0, 1)
    naive = F.conv_transpose2d(_t(x).permute(0, 3, 1, 2), unflipped, up.bias, stride=2,
                               padding=1).permute(0, 2, 3, 1)
    assert np.abs(naive.detach().numpy() - want).max() > 1e-2


def test_self_attention_groupnorm_eps_is_flax_default():
    """flax GroupNorm's eps is 1e-6; on a low-variance input torch's 1e-5
    would change the normalised values by several percent."""
    rng = np.random.default_rng(8)
    h = _rand(rng, 2, 4, 4, 32, scale=2e-3)
    mod = JaxSelfAttention2D()
    params = jax.tree.map(lambda a: np.asarray(a) + _rand(rng, *np.shape(a), scale=0.2),
                          jax.jit(mod.init)(jax.random.key(2), h))
    want = np.asarray(jax.jit(mod.apply)(params, h))
    attn = load_flax_params(SelfAttention2D(32), params)
    with torch.no_grad():
        got = attn(_t(h))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        attn.norm.eps = 1e-5
        assert np.abs(attn(_t(h)).numpy() - want).max() > 1e-3


def test_decoder_layer_layernorm_eps_and_tanh_gelu():
    """flax LayerNorm eps 1e-6 and jax.nn.gelu's tanh form: the layer matches
    JAX, and torch's defaults (eps 1e-5, erf GELU) would not."""
    rng = np.random.default_rng(9)
    q, mem = _rand(rng, 2, 5, 16, scale=3e-3), _rand(rng, 2, 9, 16, scale=3e-3)
    mod = JaxDecoderLayer(16)
    params = jax.tree.map(lambda a: np.asarray(a) + _rand(rng, *np.shape(a), scale=0.5),
                          jax.jit(mod.init)(jax.random.key(3), q, mem))
    want = np.asarray(jax.jit(mod.apply)(params, q, mem))
    layer = load_flax_params(ScaledDecoderLayer(16), params)
    with torch.no_grad():
        got = layer(_t(q), _t(mem)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert layer.ln_q.eps == layer.ln_m.eps == layer.ln_mlp.eps == 1e-6
    x = torch.linspace(-3, 3, 61)
    np.testing.assert_allclose(F.gelu(x, approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(x.numpy())), rtol=1e-6, atol=1e-6)
    assert (F.gelu(x) - F.gelu(x, approximate="tanh")).abs().max() > 1e-4


# --------------------------------------------------------------------------- #
# guards                                                                       #
# --------------------------------------------------------------------------- #


IMPORT_CHECK = (
    "import importlib, pkgutil, sys\n"
    "import instancediff_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, 'instancediff_torch.'):\n"
    "    importlib.import_module(m.name)\n"
    "import chip_smoke\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'instancediff_tpu'))\n"
    "assert not bad, bad\n"
    "print('ok', len([n for n in sys.modules if n.startswith('instancediff_torch')]))\n")


@pytest.fixture(scope="module", autouse=True)
def fresh_interpreters():
    """The checks that run in a fresh interpreter, each seconds of importing
    torch and the port, started with the module's first test so that they
    run beside the others: the import check, and (without CUDA)
    ``chip_smoke.py`` itself. ``finish(name)`` waits for one and gives its
    CompletedProcess."""
    cmds = {"imports": [sys.executable, "-c", IMPORT_CHECK]}
    if not torch.cuda.is_available():
        cmds["chip_smoke"] = [sys.executable, "chip_smoke.py"]
    procs = {name: subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}

    def finish(name):
        out, err = procs[name].communicate(timeout=120)
        return subprocess.CompletedProcess(cmds[name], procs[name].returncode, out, err)

    yield finish
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_port_imports_no_jax(fresh_interpreters):
    """Every module of the package, and chip_smoke as a module, import
    without pulling in jax, flax, msgpack or the JAX package (the port reads
    and writes flax msgpack bundles with its own codec)."""
    out = fresh_interpreters("imports")
    assert out.returncode == 0, out.stderr
    # the package and every module, ddpm_model, ddpm_sde and group_norm_silu included
    assert int(out.stdout.split()[1]) >= 23


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
    from instancediff_torch.models.drift_model import CLIPDriftEngine
    from instancediff_torch.serving import Restorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = dict(nf=8, ch_mult=[1, 2], context_dim=16, score_map_chan=4,
                    num_res_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIPDriftEngine(settings, settings, tiny_text_encoder=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIPDDPMEngine(settings, tiny_text_encoder=True)
    with pytest.raises(KeyError, match="engine knob"):
        CLIPDriftEngine(settings, settings, engine_opts={"fused_gnconv": 0, "fused_conv": 1},
                        tiny_text_encoder=True, device="cpu")
    eng = CLIPDriftEngine(settings, settings, score_map_ch_mult=(1, 1), score_map_ngf=8,
                          tiny_text_encoder=True, engine_opts={"fused_gnconv": 0},
                          device="cpu")
    ddpm = CLIPDDPMEngine(dict(settings, score_map_ngf=8), tiny_text_encoder=True,
                          device="cpu")
    for engine in (eng, ddpm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Restorer(engine)
        Restorer(engine, device="cpu")
    # the distillation driver and the demos default to the card too
    from instancediff_torch.tools import demo_all_modalities, demo_restoration
    from instancediff_torch.tools import distill as distill_tool

    with pytest.raises(RuntimeError, match="device='cpu'"):
        distill_tool.main(["-opt", "Configurations/tiny_cpu.yml", "--phases", "4"])
    for demo in (demo_restoration, demo_all_modalities):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            demo.main([])


def test_chip_smoke_fails_without_cuda(fresh_interpreters):
    if torch.cuda.is_available():
        pytest.skip("checks the script's refusal on a machine without CUDA")
    out = fresh_interpreters("chip_smoke")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
