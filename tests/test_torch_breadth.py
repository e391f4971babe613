"""The port's factories, SMM-less UNet and utilities against the JAX package
on the CPU: ``models.modules.create_net`` for every registry name, the UNet
without SMM text conditioning on both ResBlock bodies, the engines' refusal
of it, ``utils.tracing``, the on-device metrics, the image and file
helpers, ``ops.resize.resize_like`` and ``data.util``'s colour conversion.

No JAX engine is built: the nets' trees come from ``jax.eval_shape`` of
their init, every leaf then drawn from a numpy seed."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.data import util as jax_data_util
from instancediff_tpu.models import modules as jax_modules
from instancediff_tpu.ops.resize import resize_like as jax_resize_like
from instancediff_tpu.utils import file_utils as jax_file_utils
from instancediff_tpu.utils import img_utils as jax_img_utils
from instancediff_tpu.utils import metrics as jax_metrics
from instancediff_tpu.utils import tracing as jax_tracing

from instancediff_torch import ops, utils
from instancediff_torch.data import util as data_util
from instancediff_torch.models import LearnableFDUnet, MSM_degEmb_Unet
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.modules import _NET_REGISTRY, create_net
from instancediff_torch.models.unet import LearnableForwardUNet, LearnableForwardUNetMultiScoreMap
from instancediff_torch.utils import file_utils, img_utils, metrics, tracing
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import one_torch_thread, quick_jax_compiles, randomize  # noqa: F401

RES, B, TOKEN_DIM = 16, 2, 24
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], num_res_blocks=1, context_dim=16,
                score_map_chan=4, score_map_ch_mult=[1, 1], score_map_ngf=8,
                use_image_context=True)
# (registry name, text_module): every name with the score maps, and both
# UNet classes without them
NETS = [("LearnableForwardUNet_MultiScoreMap", "scoremap"), ("LearnableForwardUNet", "scoremap"),
        ("ConditionalUNet", "scoremap"), ("LearnableForwardUNet_MultiScoreMap", "none"),
        ("LearnableForwardUNet", "none")]


def _settings(class_name, text_module):
    return dict(SETTINGS, class_name=class_name, text_module=text_module)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return dict(x_a=rng.standard_normal((B, RES, RES, 1)).astype(np.float32),
                x_b=rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
                t=np.array([3, 1], np.int32), type_idx=np.array([4, 1], np.int32),
                emb=rng.standard_normal((B, 1, SETTINGS["context_dim"])).astype(np.float32),
                text=[rng.standard_normal((5, SETTINGS["context_dim"])).astype(np.float32)
                      for _ in SETTINGS["ch_mult"]])


@pytest.fixture(scope="module")
def jax_nets(inputs):
    """(registry name, text_module) -> (JAX module, its parameters, every
    leaf drawn from a numpy seed), built on first use."""
    built = {}

    def get(class_name, text_module):
        key = (class_name, text_module)
        if key not in built:
            net = jax_modules.create_net(_settings(*key), token_embed_dim=TOKEN_DIM)
            i = inputs
            shapes = jax.eval_shape(
                lambda: net.init(jax.random.key(0), i["x_a"], i["x_b"], i["t"], i["type_idx"],
                                 image_context=i["emb"], text_embs=i["text"]))
            zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
            built[key] = net, randomize(zeros, np.random.default_rng(len(built)))
        return built[key]

    return get


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


@pytest.mark.parametrize("class_name,text_module", NETS)
def test_create_net_builds_the_jax_tree(jax_nets, class_name, text_module):
    """The port's ``create_net`` builds JAX's module tree for every registry
    name: every leaf of the JAX tree fills a parameter (``load_flax_params``
    raises on a leftover or a missing leaf) and comes back unchanged."""
    jnet, params = jax_nets(class_name, text_module)
    net = create_net(_settings(class_name, text_module), token_embed_dim=TOKEN_DIM,
                     device="cpu")
    assert type(net) is _NET_REGISTRY[class_name]
    assert net.if_MultiScoreMap == jnet.if_MultiScoreMap
    assert net.n_smms == (0 if text_module != "scoremap" else
                          len(SETTINGS["ch_mult"]) if jnet.if_MultiScoreMap else 1)
    load_flax_params(net, params)
    got, want = _flat(flax_params(net)), _flat(params)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg="/".join(path))
    if text_module != "scoremap":
        assert not any(p[1].startswith("smm") for p in want)


def test_create_net_factory_options():
    assert set(_NET_REGISTRY) == set(jax_modules._NET_REGISTRY)
    assert LearnableFDUnet.LearnableForwardUNet is LearnableForwardUNet
    assert MSM_degEmb_Unet.LearnableForwardUNet_MultiScoreMap is LearnableForwardUNetMultiScoreMap
    assert MSM_degEmb_Unet.ScoreMapModule is not None
    with pytest.raises(ValueError, match="unknown net class"):
        create_net(dict(SETTINGS, class_name="UNet2"), device="cpu")
    net = create_net(dict(SETTINGS, class_name="LearnableForwardUNet", if_MultiScoreMap=True),
                     token_embed_dim=TOKEN_DIM, dtype=torch.bfloat16, device="cpu")
    assert net.if_MultiScoreMap and net.conv_in.weight.dtype == torch.bfloat16
    assert net.norm_out.weight.dtype == torch.float32  # norms stay float32


@pytest.mark.parametrize("fused", [True, False], ids=["fused_body", "unfused_body"])
@pytest.mark.parametrize("class_name", ["LearnableForwardUNet_MultiScoreMap",
                                        "LearnableForwardUNet"])
def test_smm_less_unet_forward_matches_jax(jax_nets, inputs, class_name, fused):
    """``text_module: none``: no SMM, ``[h, skip]`` into each level's first
    decoder block, ``pred`` alone, on both ResBlock bodies (on the CPU the
    kernels' plain versions), against the JAX net in float32."""
    jnet, params = jax_nets(class_name, "none")
    i = inputs
    want = np.asarray(jax.jit(lambda p, *a: jnet.apply(p, *a[:4], image_context=a[4]))(
        params, i["x_a"], i["x_b"], i["t"], i["type_idx"], i["emb"]))
    net = load_flax_params(create_net(_settings(class_name, "none"), token_embed_dim=TOKEN_DIM,
                                      device="cpu", use_fused_gnconv=fused), params)
    assert net.dec_0_0.in_ch == 2 * SETTINGS["nf"]  # no score-map channels
    with torch.no_grad():
        pred = net(torch.from_numpy(i["x_a"]), torch.from_numpy(i["x_b"]),
                   torch.from_numpy(i["t"]), torch.from_numpy(i["type_idx"]),
                   image_context=torch.from_numpy(i["emb"]))
    assert isinstance(pred, torch.Tensor) and pred.shape == (B, RES, RES, 1)
    # float32 on both sides, ~10 chained convs with random weights:
    # summation order only (as tests/test_torch_engine.py:test_unet_forward)
    np.testing.assert_allclose(pred.numpy(), want, rtol=1e-4, atol=1e-4)


def test_engines_refuse_an_smm_less_net():
    """JAX's engines unpack (pred, score maps) from every forward, so no JAX
    engine serves an SMM-less net; the port's refuse one by name."""
    s = dict(SETTINGS, text_module="none")
    with pytest.raises(ValueError, match="text_module 'none'"):
        CLIPDriftEngine(s, s, score_map_ch_mult=(1, 1), tiny_text_encoder=True, device="cpu")
    with pytest.raises(ValueError, match="text_module 'none'"):
        CLIPDDPMEngine(s, tiny_text_encoder=True, device="cpu")


# ---------------------------------------------------------------- tracing


def _fake_clock(monkeypatch, module, values):
    it = iter(values)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


def test_step_timer_matches_jax(monkeypatch):
    """The same step durations (the clock patched) give JAX's summary and
    message, the warm-up steps kept apart."""
    stamps = np.cumsum([0.0, 2.5, 0.1, 0.03, 0.12, 0.2, 0.05, 0.11, 0.04, 0.3, 0.07]).tolist()
    timers = []
    for module in (jax_tracing, tracing):
        _fake_clock(monkeypatch, module, stamps)
        timer = module.StepTimer(warmup=2)
        for _ in range(5):
            with timer:
                pass
        timers.append(timer)
    jt, pt = timers
    assert pt.summary() == jt.summary() and pt.message() == jt.message()
    assert pt.summary()["steps"] == 3 and pt.warmup_times == jt.warmup_times
    assert tracing.StepTimer().summary() == jax_tracing.StepTimer().summary()


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tracing.trace(log_dir):
        with tracing.annotate("breadth.request"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, tracing.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert "breadth.request" in names and any("mm" in str(n) for n in names)


def test_device_memory_stats_empty_on_the_cpu():
    assert tracing.device_memory_stats() == jax_tracing.device_memory_stats() == {}


# ---------------------------------------------------------------- metrics


@pytest.fixture(scope="module")
def image_pairs():
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (3, 40, 48)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, [[[0.02]], [[0.1]], [[0.3]]], target.shape), 0, 1)
    return pred.astype(np.float32), target


def test_on_device_metrics_match_jax(image_pairs):
    """``psnr_tensor``/``ssim_tensor`` on a batch: each image's value equals
    ``psnr_jnp``/``ssim_jnp``'s and the host skimage-parity metrics', within
    float32 roundoff (1e-4 dB, 1e-5 SSIM)."""
    pred, target = image_pairs
    psnr = metrics.psnr_tensor(torch.from_numpy(pred), torch.from_numpy(target))
    ssim = metrics.ssim_tensor(torch.from_numpy(pred), torch.from_numpy(target))
    assert psnr.shape == ssim.shape == (3,)
    for j in range(3):
        np.testing.assert_allclose(psnr[j].item(),
                                   float(jax_metrics.psnr_jnp(pred[j], target[j])), atol=1e-4)
        np.testing.assert_allclose(ssim[j].item(),
                                   float(jax_metrics.ssim_jnp(pred[j], target[j])), atol=1e-5)
        np.testing.assert_allclose(ssim[j].item(), metrics.calculate_ssim(pred[j], target[j]),
                                   atol=1e-5)
        np.testing.assert_allclose(psnr[j].item(), metrics.calculate_psnr(pred[j], target[j]),
                                   atol=1e-4)
    np.testing.assert_array_equal(metrics.gaussian_kernel1d(), jax_metrics._gaussian_kernel1d())
    # one image, [H, W]: a scalar; equal images: the MSE floor
    assert metrics.ssim_tensor(torch.from_numpy(pred[0]), torch.from_numpy(target[0])).dim() == 0
    np.testing.assert_allclose(metrics.psnr_tensor(torch.zeros(8, 8), torch.zeros(8, 8)).item(),
                               float(jax_metrics.psnr_jnp(np.zeros((8, 8)), np.zeros((8, 8)))))


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    for img in (rng.integers(0, 256, (12, 10, 3), dtype=np.uint8),
                rng.uniform(0, 255, (12, 10, 3)).astype(np.float32),
                rng.uniform(0, 1, (12, 10)).astype(np.float64)):
        got = img_utils.img2tensor(img)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), jax_img_utils.img2tensor(img))
    path = str(tmp_path / "x.raw")
    arr = rng.standard_normal((1, 6, 7)).astype(np.float32)
    utils.save_raw(arr, path)
    np.testing.assert_array_equal(utils.load_raw(path, (1, 6, 7)),
                                  jax_img_utils.load_raw(path, (1, 6, 7)))
    # MATLAB-convention metrics on [0, 255] images: the same numpy code
    a = rng.uniform(0, 255, (30, 34, 3))
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255)
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a[..., :1], b[..., :1])):
        assert img_utils.calculate_psnr(x, y) == jax_img_utils.calculate_psnr(x, y)
        assert img_utils.calculate_ssim(x, y) == jax_img_utils.calculate_ssim(x, y)
    assert img_utils.calculate_psnr(a, a) == float("inf")
    with pytest.raises(ValueError, match="same dimensions"):
        img_utils.calculate_ssim(a, b[:-1])
    with pytest.raises(ValueError, match="Wrong input"):
        img_utils.calculate_ssim(a[..., :2], b[..., :2])
    # distinct from the skimage-parity metrics of utils/metrics.py
    assert img_utils.calculate_ssim is not metrics.calculate_ssim


def test_files_and_progress_bar_match_jax(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "a" / "b")
    file_utils.mkdir(d)
    file_utils.mkdir(d)
    assert os.path.isdir(d)
    outputs = []
    for module in (jax_file_utils, file_utils):
        # JAX's bar imports time inside its methods; the port's at the top
        clock = iter([100.0, 100.5, 101.75, 103.0, 200.0, 200.25, 210.0])
        monkeypatch.setattr("time.time", lambda: next(clock))
        bar = module.ProgressBar(3, bar_width=20)
        for msg in ("one", "two", "three"):
            bar.update(msg)
        counter = module.ProgressBar()
        counter.update()
        counter.update()
        monkeypatch.undo()
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "[>>>>>>>>>>>>>>>>>>>>] 3/3" in outputs[1]


# ---------------------------------------------------------------- resize, colour


@pytest.mark.parametrize("hw", [(12, 18), (8, 12), (6, 9), (48, 72), (72, 108), (17, 29),
                                (31, 50), (5, 7), (100, 13)],
                         ids=["down2", "down3", "down4", "up2", "up3", "down_odd", "up_odd",
                              "down_4.8x5.1", "up_h_down_w"])
def test_resize_like_matches_jax_image_resize(hw):
    """Antialiased bilinear both ways, at power-of-two, odd and non-integer
    factors: ``F.interpolate(antialias=True)`` against ``jax.image.resize``.
    Found: <= 5.4e-6 on values of standard deviation 1 (float32 weights
    summed in another order; largest at 3x upsampling); held to 1e-5."""
    x = np.random.default_rng(0).standard_normal((2, 24, 36, 3)).astype(np.float32)
    want = np.asarray(jax_resize_like(jnp.asarray(x), *hw))
    got = ops.resize_like(torch.from_numpy(x), *hw)
    assert got.shape == want.shape == (2, *hw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("only_y", [True, False], ids=["y", "ycbcr"])
def test_ycbcr_matches_jax(only_y):
    rng = np.random.default_rng(7)
    for img in (rng.integers(0, 256, (9, 11, 3), dtype=np.uint8),
                rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)):
        for fn in ("bgr2ycbcr", "rgb2ycbcr"):
            got = getattr(data_util, fn)(img, only_y=only_y)
            want = getattr(jax_data_util, fn)(img, only_y=only_y)
            assert got.dtype == want.dtype == img.dtype
            np.testing.assert_array_equal(got, want)


def test_exports_match_jax():
    import instancediff_tpu.ops as jax_ops
    import instancediff_tpu.utils as jax_utils

    assert utils.__all__ == jax_utils.__all__ and ops.__all__ == jax_ops.__all__
    assert all(callable(getattr(utils, n)) for n in utils.__all__)
