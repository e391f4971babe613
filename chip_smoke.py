"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain PyTorch versions.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --sweep [conv|gn]`` builds the kernels and only times
plan choices at each flagship launch shape: the bf16 fused conv under each
tile / N-block choice beside cuDNN, and the GroupNorm kernels on the
two-launch path and the cluster path (8 blocks per image) beside
``F.group_norm`` + ``F.silu``; both without an argument.)

Phases, one JSON line each, in order:
  1. build   -- nvcc builds every kernel of ``instancediff_torch/csrc`` for
                sm_90a into the ignored ``instancediff_torch/_build/`` (one
                nvcc per source, in parallel) and reports ptxas's registers
                and spills; a spilling tensor-core kernel fails the run;
  2. check   -- each kernel against its plain version on the card at the main
                paths' shapes and at the edges of the conv kernel's tiling,
                in bf16 and fp32: max abs error (with the stated tolerance),
                kernel ms (CUDA events around one call, the wrapper's host
                time included) and device_ms (the kernel's own device time
                per call, summed by torch.profiler), the conv's achieved
                TFLOP/s, plain ms, one library call's ms (a yardstick only:
                the port never calls it) and the bound;
  3. main    -- three paths at full width, each answering requests through
                ``Restorer.restore`` on the compiled sampler (one CUDA graph of
                the sampler step, captured at the path's first call and
                replayed once per step) with seeded random weights, 256 px,
                batch 8, bf16, 4 of T=100 steps, eta 1: 8 images (captures),
                3 (padded to 8: replays the same graph), 8 again (steady
                state); then the first request's batch eagerly
                (``compiled=False``, the same generator seed), held against
                the graph's output (max abs error, bit-identical or not, ms
                per step of both). Launch counts are zeroed before each
                request and checked after it. A wrapper counts the kernels
                it launches; under capture it records the kernel into the
                graph instead, and each replay adds the per-step counts
                recorded at capture (``CompiledStep.replay``). So a
                capturing request counts its eager warm-up step and its
                replays (steps + 1 times the per-step counts), a replaying
                one its replays, the eager one every step; the replays are
                read from the graph's own count, and the per-step counts
                recorded at capture must equal:
                  drift        -- the flagship drift sampler (bench.py's
                                  flagship: nf 64, ch_mult [1,2,4,4], 2
                                  ResBlocks per level, 12-layer CLIP text
                                  tower) on the fused ResBlock body: 90
                                  fused-conv, 2 flash, 90 gn_channel_affine
                                  (GroupNorm statistics), 0 GroupNorm
                                  launches; and one request of 8 images at
                                  all T=100 steps (bench.py's flagship step
                                  count), twice (capture, steady), with img/s;
                  drift_unfused -- the same engine with
                                  ``engine_opts={"fused_gnconv": False}``: 90
                                  GroupNorm, 0 fused-conv, 0 statistics, 2
                                  flash launches;
                  ddpm         -- the DDPM baseline at
                                  Configurations/flagship_ddpm_tpu.yml's widths
                                  (single score map, T=100, max_sigma 1): 45
                                  GroupNorm, 1 flash launch;
                then ``profile``: one request's replayed steps, each alone on
                the device (a synchronise before and after each replay),
                under torch.profiler: per replayed step the device time by
                kernel class, the device's idle share, the launches of each
                kernel counted by name against the per-step counts, and the
                host's kernel and graph launches per step (the call's text
                encodings counted apart); the SM clock before and after;
  4. parity  -- full-width fp32 sampler calls (batch 2, 2 steps, eta 0)
                replayed from the graph against the eager loop (1e-5 abs),
                drift and DDPM; then UNet forwards (fp32, batch 2) through
                the kernels and through the plain versions, compared: the
                drift net on the fused body, on the unfused body, the
                unfused body against the fused one on the same weights, and
                the DDPM net;
  5. per_forward -- every kernel each main path launches, held against its
                plain version and timed at that path's own launch shapes
                (bf16, batch 8), summed over one UNet forward (ms and
                device_ms); then the ``{"kernels": [...]}`` line (each
                kernel's times from the first path that launches it:
                fused-conv, flash and gn_channel_affine from drift, GroupNorm
                from drift_unfused; max_abs_err over every shape),
                the card's name and power limit, and last
                ``{"ok": true, "device": {...}}``. A kernel's ``launches`` are
                its wrapper's counts over the graph-served main requests:
                the warm-up steps' launches plus, per replay, the per-step
                count recorded at capture (the eager comparison is counted
                apart); ``profile`` counts the replayed kernels by name on
                the device and holds them to the same per-step counts.

Any failure raises and the script exits non-zero; a failed capture too (the
engines never fall back to the eager loop). Without CUDA it exits 1 before
doing anything."""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch

from instancediff_torch.models import unet as unet_mod
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.engine import ARTIFACT_PROMPTS, KERNELS
from instancediff_torch.models.layers import ConvParams
from instancediff_torch.ops import _build
from instancediff_torch.ops.flash_attention import flash_attention, flash_attention_plain
from instancediff_torch.ops.fused_gn_conv import (conv_plan, fused_gn_silu_conv3x3,
                                                  fused_gn_silu_conv3x3_plain, gn_channel_affine,
                                                  gn_channel_affine_plain, pack_weights)
from instancediff_torch.ops.group_norm_silu import (CLUSTER, SMEM_LIMIT, cluster_smem_bytes,
                                                    gn_plan, group_norm_affine_cuda,
                                                    group_norm_silu, group_norm_silu_cuda,
                                                    group_norm_silu_plain)
from instancediff_torch.sde import DDPMSDE, DriftSDE
from instancediff_torch.sde.schedules import strided_sampling_grid
from instancediff_torch.serving import Restorer

# H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s by operand type
# (bf16 on the tensor cores; fp32 on the FMA units, which the fp32 kernels use)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain on the card: max |diff| <= TOL * max(1, max |plain|).
# fp32: the same fp32 arithmetic in another summation order. bf16: both
# round the activation and the result to bf16, so a result may differ by one
# bf16 ulp (2^-8 relative) where the fp32 sums straddle a rounding boundary.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# full-width fp32 UNet forward, kernels vs plain: 22 ResBlocks of fp32 sums
# in another order; relative to the largest output
FORWARD_TOL = 1e-3

FLAGSHIP = dict(in_nc=2, out_nc=5, nf=64, ch_mult=[1, 2, 4, 4], context_dim=512,
                text_module="scoremap", score_map_chan=16, if_MultiScoreMap=True,
                num_res_blocks=2)
# Configurations/flagship_ddpm_tpu.yml models.DDPM.net_settings (score_map_ngf
# takes the engine's default, 64) and sdes.ddpm
DDPM_NET = dict(in_nc=2, out_nc=5, nf=64, ch_mult=[1, 2, 4, 4], num_res_blocks=2,
                context_dim=512, text_module="scoremap", score_map_chan=16)
DDPM_MAX_SIGMA = 1.0
RES, BATCH, T, SAMPLE_STEPS, ETA = 256, 8, 100, 4, 1.0
CONV_SHAPES = [  # (B, H, W, C, Cout, residual)
    (8, 256, 256, 64, 64, False), (8, 256, 256, 144, 64, False),
    (8, 64, 64, 528, 256, False), (8, 32, 32, 256, 256, True), (8, 256, 256, 64, 5, False),
    # edges of the bf16 kernel's tiling: W not a multiple of the tile (the
    # 224 px decoder levels), and C not a multiple of 8 (the scalar halo path)
    (8, 28, 28, 528, 256, False), (8, 56, 56, 272, 128, False), (8, 64, 64, 20, 5, False)]
FLASH_SHAPES = [(8, 4, 1024, 64), (8, 4, 784, 64)]
GN_SHAPES = [  # (B, H, W, C, groups, silu)
    (8, 256, 256, 64, 32, True), (8, 256, 256, 144, 24, True), (8, 128, 128, 272, 17, True),
    (8, 64, 64, 528, 24, True), (8, 32, 32, 512, 32, True)]
AFFINE_SHAPES = [  # (B, H, W, C, groups); C = 20 with odd H and W: the one-element path
    (8, 256, 256, 64, 32), (8, 256, 256, 144, 24), (8, 128, 128, 272, 17), (8, 64, 64, 528, 24),
    (8, 32, 32, 256, 32), (3, 19, 23, 20, 5)]
# per kernel: its CUDA source and the TPU kernel it replaces
SOURCES = {"conv": ("instancediff_torch/csrc/fused_gn_silu_conv3x3.cu",
                    "instancediff_tpu/ops/pallas_kernels.py:373"),
           "flash": ("instancediff_torch/csrc/flash_attention.cu",
                     "instancediff_tpu/ops/pallas_kernels.py:221"),
           "gn": ("instancediff_torch/csrc/group_norm_silu.cu",
                  "instancediff_tpu/ops/pallas_kernels.py:134"),
           # the jnp statistics pass of the fused body (not a pallas_call)
           "affine": ("instancediff_torch/csrc/group_norm_silu.cu",
                      "instancediff_tpu/ops/pallas_kernels.py:279")}
NAMES = {"conv": "fused_gn_silu_conv3x3", "flash": "flash_attention", "gn": "group_norm_silu",
         "affine": "gn_channel_affine"}
# the one PyTorch call timed beside each kernel (a yardstick; the port never calls it)
LIBRARY = {"conv": "F.conv2d (cuDNN) on the normalised input",
           "flash": "F.scaled_dot_product_attention", "gn": "F.group_norm + F.silu",
           "affine": "torch.var_mean over the [B, HW, G, Cg] view: the nearest call (group "
                     "mean and variance, not per-channel scale and shift)"}
# the kernels' wrappers, whose ``launches`` count their launches
WRAPPERS = {k: KERNELS[name] for k, name in NAMES.items()}
# launches per sampler step on each main path
PATHS = {"drift": {"conv": 90, "flash": 2, "gn": 0, "affine": 90},
         "drift_unfused": {"conv": 0, "flash": 2, "gn": 90, "affine": 0},
         "ddpm": {"conv": 0, "flash": 1, "gn": 45, "affine": 0}}


# kernels whose registers must not spill: a wgmma accumulator spilled while
# the instruction runs would be lost
NO_SPILL = ("fgc_tc_kernel", "flash_tc_kernel")


def ptxas_report(logs) -> tuple:
    """({entry: spill stores + loads in bytes}, {entry: registers}) per
    compiled entry (the start of its mangled name), from nvcc's ``-Xptxas
    -v`` output."""
    spills, regs, entry = {}, {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:  # from the kernel's own name on (fgc_..., flash_..., gns_...)
                name = m.group(1)
                entry = name[re.search(r"(fgc|flash|gns)_", name).start():][:48]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and entry:
                spills[entry] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                regs[entry] = int(m.group(1))
    return spills, regs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kname: str, reps: int = 10, attempts: int = 3) -> float:
    """Device time per call of ``fn`` spent in kernel ``kname``'s own CUDA
    kernels (names in ``KERNEL_CLASSES``), summed by torch.profiler over
    ``reps`` calls after a warm-up: the kernel time without the host's. A
    profiling window that records no kernel at all (it happens, rarely, on
    the card's machine) is taken again, up to ``attempts`` windows."""
    from torch.profiler import ProfilerActivity, profile

    keys = dict(KERNEL_CLASSES)[CLASS_OF[kname]]
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(evt.time_range.elapsed_us() for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in evt.name.lower() for k in keys))
        if us > 0:
            return us / reps / 1e3
    raise AssertionError(f"torch.profiler recorded no {kname} kernel in {attempts} windows")


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_err(name, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    limit = TOL[dtype] * max(1.0, want.float().abs().max().item())
    if not (err <= limit):  # also catches NaN
        raise AssertionError(f"{name}: kernel vs plain max abs err {err} > {limit}")
    return err


# ---------------------------------------------------------------- the kernels


def conv_case(shape, dtype, gen):
    B, H, W, C, Cout, residual = shape
    dev = "cuda"
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    scale = 1 + 0.2 * torch.randn(B, C, generator=gen, device=dev)
    shift = 0.3 * torch.randn(B, C, generator=gen, device=dev)
    w = (torch.randn(3, 3, C, Cout, generator=gen, device=dev) / (9 * C) ** 0.5).to(dtype)
    bias = 0.1 * torch.randn(B, Cout, generator=gen, device=dev)
    res = torch.randn(B, H, W, Cout, generator=gen, device=dev).to(dtype) if residual else None
    return x, scale, shift, w, bias, res


def conv_cost(shape, dtype):
    B, H, W, C, Cout, residual = shape
    s = torch.finfo(dtype).bits // 8
    nbytes = (B * H * W * C * s + 2 * B * C * 4 + 9 * C * Cout * s + B * Cout * 4
              + B * H * W * Cout * s * (2 if residual else 1))
    return bound(nbytes, 2.0 * B * H * W * 9 * C * Cout, dtype)


def measure_conv(shape, dtype, gen):
    x, scale, shift, w, bias, res = conv_case(shape, dtype, gen)
    got = fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res)
    torch.cuda.synchronize()
    want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias, residual=res)
    err = check_err(f"fused conv {shape} {dtype}", got, want, dtype)
    # library yardstick: cuDNN's conv alone, on the already-normalised input,
    # channels-last (the port's NHWC layout, cuDNN's tensor-core layout)
    xn = torch.nn.functional.silu(
        x.float() * scale[:, None, None] + shift[:, None, None]).to(dtype)
    xn = xn.permute(0, 3, 1, 2)
    wk = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bound_ms, bound_by = conv_cost(shape, dtype)
    ms = cuda_ms(lambda: fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res))
    B, H, W, C, Cout, _ = shape
    return dict(
        max_abs_err=err, ms=ms, tflops=2.0 * B * H * W * 9 * C * Cout / (ms * 1e-3) / 1e12,
        device_ms=device_ms(lambda: fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=res),
                            "conv"),
        plain_ms=cuda_ms(lambda: fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias,
                                                             residual=res)),
        library_ms=cuda_ms(lambda: torch.nn.functional.conv2d(xn, wk, padding=1)),
        bound_ms=bound_ms, bound_by=bound_by)


def measure_flash(shape, dtype, gen):
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = check_err(f"flash {shape} {dtype}", got, flash_attention_plain(q, k, v), dtype)
    B, Hh, N, D = shape
    s = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(4 * B * Hh * N * D * s, 4.0 * B * Hh * N * N * D, dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: flash_attention(q, k, v)),
        device_ms=device_ms(lambda: flash_attention(q, k, v), "flash"),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v)),
        library_ms=cuda_ms(lambda: sdpa(q, k, v)), bound_ms=bound_ms, bound_by=bound_by)


def gn_case(B, H, W, C, dtype, gen):
    dev = "cuda"
    x = (0.5 + torch.randn(B, H, W, C, generator=gen, device=dev)).to(dtype)
    gamma = 1 + 0.2 * torch.randn(C, generator=gen, device=dev)
    beta = 0.3 * torch.randn(C, generator=gen, device=dev)
    return x, gamma, beta


def gn_cost(shape, dtype):
    B, H, W, C, G, silu = shape
    n = B * H * W * C
    # read x once, write y once; ~10 fp32 operations per element with SiLU
    # (sum, square-add, subtract, 2 multiplies, add, exp, add, divide), 7
    # without, on the fp32 units whatever x's dtype
    return bound(2 * n * (torch.finfo(dtype).bits // 8) + 2 * C * 4,
                 (10 if silu else 7) * n, torch.float32)


def measure_gn(shape, dtype, gen):
    B, H, W, C, G, silu = shape
    x, gamma, beta = gn_case(B, H, W, C, dtype, gen)
    got = group_norm_silu(x, gamma, beta, G, silu=silu)
    torch.cuda.synchronize()
    want = group_norm_silu_plain(x, gamma, beta, G, silu=silu)
    err = check_err(f"group_norm_silu {shape} {dtype}", got, want, dtype)
    bound_ms, bound_by = gn_cost(shape, dtype)
    # library yardstick: torch's GroupNorm then SiLU on the NCHW view
    # (channels-last) of the same tensor
    xn, g, b = x.permute(0, 3, 1, 2), gamma.to(dtype), beta.to(dtype)

    def library():
        y = torch.nn.functional.group_norm(xn, G, g, b, 1e-5)
        return torch.nn.functional.silu(y) if silu else y

    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: group_norm_silu(x, gamma, beta, G, silu=silu)),
        device_ms=device_ms(lambda: group_norm_silu(x, gamma, beta, G, silu=silu), "gn"),
        path=gn_plan(B, H * W, C, G, x.element_size())["path"],
        plain_ms=cuda_ms(lambda: group_norm_silu_plain(x, gamma, beta, G, silu=silu)),
        library_ms=cuda_ms(library), bound_ms=bound_ms, bound_by=bound_by)


def affine_cost(shape, dtype):
    B, H, W, C, G = shape
    n = B * H * W * C
    # read x (and gamma, beta) once, write scale and shift [B, C] fp32 once;
    # an add and a fused multiply-add per element on the fp32 units
    return bound(n * (torch.finfo(dtype).bits // 8) + 2 * C * 4 + 2 * B * C * 4, 2.0 * n,
                 torch.float32)


def measure_gn_affine(shape, dtype, gen):
    B, H, W, C, G = shape
    x, gamma, beta = gn_case(B, H, W, C, dtype, gen)
    got = gn_channel_affine(x, gamma, beta, G)
    torch.cuda.synchronize()
    want = gn_channel_affine_plain(x, gamma, beta, G)
    # float32 outputs of the same inputs in both versions: the fp32 tolerance
    err = max(check_err(f"gn_channel_affine {what} {shape} {dtype}", g, w, torch.float32)
              for what, g, w in zip(("scale", "shift"), got, want))
    bound_ms, bound_by = affine_cost(shape, dtype)
    xv = x.view(B, H * W, G, C // G)  # torch accumulates a bf16 reduction in fp32
    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: gn_channel_affine(x, gamma, beta, G)),
        device_ms=device_ms(lambda: gn_channel_affine(x, gamma, beta, G), "affine"),
        plain_ms=cuda_ms(lambda: gn_channel_affine_plain(x, gamma, beta, G)),
        library_ms=cuda_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0)),
        bound_ms=bound_ms, bound_by=bound_by)


MEASURE = {"conv": measure_conv, "flash": measure_flash, "gn": measure_gn,
           "affine": measure_gn_affine}


# ---------------------------------------------------------------- the models


def randomize_(module: torch.nn.Module, seed: int) -> None:
    """Seeded numpy values for every parameter: weights ~ N(0, 1/fan_in),
    norm scales ~ 1 + 0.1 N, biases and free parameters ~ init + 0.1 N."""
    rng = np.random.default_rng(seed)
    modules = dict(module.named_modules())
    with torch.no_grad():
        for name, p in module.named_parameters():
            *path, pname = name.split(".")
            owner = modules[".".join(path)]
            shape = tuple(p.shape)
            if pname == "weight" and isinstance(owner, torch.nn.Embedding):
                r = rng.standard_normal(shape, dtype=np.float32)
            elif pname == "weight" and isinstance(owner, ConvParams):
                r = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(9 * shape[2])
            elif pname == "weight" and isinstance(owner, (torch.nn.Linear, torch.nn.Conv2d,
                                                          torch.nn.ConvTranspose2d)):
                fan_in = shape[1] if isinstance(owner, torch.nn.Linear) else \
                    int(np.prod(shape[1:])) if isinstance(owner, torch.nn.Conv2d) else \
                    shape[0] * shape[2] * shape[3]
                r = rng.standard_normal(shape, dtype=np.float32) / np.sqrt(fan_in)
            elif pname == "weight":  # norms
                r = 1 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
            else:
                r = p.detach().float().cpu().numpy() + 0.1 * rng.standard_normal(
                    shape, dtype=np.float32)
            p.copy_(torch.from_numpy(np.asarray(r, dtype=np.float32)))


def flagship_engine(dtype, engine_opts=None) -> CLIPDriftEngine:
    eng = CLIPDriftEngine(FLAGSHIP, FLAGSHIP, score_map_ch_mult=(1, 1, 2, 4),
                          score_map_ngf=64, use_image_context=True, CLIP_Type="CLIP",
                          sde=DriftSDE(T=T, max_sigma=0.4), dtype=dtype,
                          engine_opts=engine_opts, device="cuda")
    for i, key in enumerate(("d_ema", "n_ema")):  # the nets test(use_ema=True) runs
        randomize_(eng.nets[key], seed=10 + i)
    randomize_(eng.text_encoder, seed=20)
    return eng


def ddpm_engine(dtype) -> CLIPDDPMEngine:
    eng = CLIPDDPMEngine(DDPM_NET, use_image_context=True, CLIP_Type="CLIP",
                         sde=DDPMSDE(T=T, max_sigma=DDPM_MAX_SIGMA), dtype=dtype,
                         device="cuda")
    randomize_(eng.nets["n_ema"], seed=30)
    randomize_(eng.text_encoder, seed=20)
    return eng


def record_launch_shapes(net, args) -> dict:
    """Run one UNet forward and return, per kernel, the (shape, dtype)
    Counter of its launches (the calls go through the real wrappers)."""
    seen = {k: Counter() for k in WRAPPERS}

    def conv_rec(x, scale, shift, w, bias, residual=None):
        B, H, W, C = x.shape
        seen["conv"][((B, H, W, C, w.shape[3], residual is not None), x.dtype)] += 1
        return fused_gn_silu_conv3x3(x, scale, shift, w, bias, residual=residual)

    def flash_rec(q, k, v):
        seen["flash"][(tuple(q.shape), q.dtype)] += 1
        return flash_attention(q, k, v)

    def gn_rec(x, gamma, beta, num_groups, eps=1e-5, silu=True):
        seen["gn"][((*x.shape, num_groups, silu), x.dtype)] += 1
        return group_norm_silu(x, gamma, beta, num_groups, eps, silu)

    def affine_rec(x, gamma, beta, num_groups, eps=1e-5):
        seen["affine"][((*x.shape, num_groups), x.dtype)] += 1
        return gn_channel_affine(x, gamma, beta, num_groups, eps)

    with mock.patch.object(unet_mod, "fused_gn_silu_conv3x3", conv_rec), \
            mock.patch.object(unet_mod, "flash_attention", flash_rec), \
            mock.patch.object(unet_mod, "group_norm_silu", gn_rec), \
            mock.patch.object(unet_mod, "gn_channel_affine", affine_rec), torch.inference_mode():
        net(*args)
    return seen


def plain_kernels():
    """Patch the UNet module's kernel wrappers with the plain versions."""
    return (mock.patch.object(unet_mod, "fused_gn_silu_conv3x3", fused_gn_silu_conv3x3_plain),
            mock.patch.object(unet_mod, "flash_attention", flash_attention_plain),
            mock.patch.object(unet_mod, "group_norm_silu", group_norm_silu_plain),
            mock.patch.object(unet_mod, "gn_channel_affine", gn_channel_affine_plain))


KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    ("fused_conv", ("fgc_tc_kernel", "fgc_fma_kernel")),
    ("flash", ("flash_tc_kernel", "flash_fma_kernel")),
    ("gn_affine", ("gns_affine_kernel",)),
    ("group_norm", ("gns_stats_kernel", "gns_apply_kernel", "gns_cluster_kernel")),
    ("library_conv", ("fprop", "conv", "dgrad", "wgrad")),
    ("gemm", ("gemm", "cutlass", "matmul")), ("reduce", ("reduce",)))
CLASS_OF = {"conv": "fused_conv", "flash": "flash", "gn": "group_norm", "affine": "gn_affine"}


# the kernels each wrapper call launches, by name: one statistics or cluster
# launch per GroupNorm call (the apply launch rides on the statistics one)
LAUNCH_NAMES = {"conv": ("fgc_tc_kernel", "fgc_fma_kernel"),
                "flash": ("flash_tc_kernel", "flash_fma_kernel"),
                "gn": ("gns_stats_kernel", "gns_cluster_kernel"), "affine": ("gns_affine_kernel",)}
# host runtime calls that put work on the device
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def flagship_batch(gen) -> dict:
    return {"input": torch.rand(BATCH, RES, RES, 1, generator=gen, device=gen.device) * 2 - 1,
            "type_idx": torch.arange(BATCH, device=gen.device) % len(ARTIFACT_PROMPTS)}


def profile_step(eng, gen, path) -> dict:
    """One request of ``SAMPLE_STEPS`` steps on the compiled sampler under
    torch.profiler, each replayed step alone on the device: a synchronise
    before the replay, then the replay and a synchronise inside a profiler
    range. Per replayed step: device time by kernel class (the kernels
    that start inside its range), busy / range wall and the idle share, each
    kernel's launches by name (checked against ``PATHS``), the top kernels;
    per step of the request loop (the engine's ``sampler_step`` ranges:
    the noise draw and the replay) the host's launch calls, and the same
    for the call's inputs (``sampler_inputs``: the text encodings). The SM
    clock is sampled before and after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    batch = flagship_batch(gen)
    eng.test(batch, gen, sample_steps=SAMPLE_STEPS, eta=ETA)  # the graph exists: a warm call
    torch.cuda.synchronize()
    entry = eng.last_graph
    replay = entry.replay

    def alone():
        torch.cuda.synchronize()
        with record_function("chip_smoke.replayed_step"):
            replay()
            torch.cuda.synchronize()

    clock_before = sm_clock()
    with mock.patch.object(entry, "replay", alone), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.test(batch, gen, sample_steps=SAMPLE_STEPS, eta=ETA)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    clock_after = sm_clock()
    events = list(prof.events())

    def ranges(name):
        return [(e.time_range.start, e.time_range.end) for e in events
                if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]

    windows = ranges("chip_smoke.replayed_step")
    if len(windows) != SAMPLE_STEPS:
        raise AssertionError(f"{path}: {len(windows)} replayed-step ranges, want {SAMPLE_STEPS}")
    # device kernels; the profiler also puts the CPU ranges on the device's
    # timeline (user annotations), which are no kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ("chip_smoke.replayed_step", "sampler_step", "sampler_inputs")]
    steps = []
    for ws, we in windows:
        by_class, by_name, n_name, launched = Counter(), Counter(), Counter(), Counter()
        for evt in kernels:
            if not ws <= evt.time_range.start <= we:
                continue
            ms = evt.time_range.elapsed_us() / 1e3
            name = evt.name.lower()
            cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                       "elementwise_other")
            by_class[cls] += ms
            by_name[evt.name[:200]] += ms
            n_name[evt.name[:200]] += 1
            for k, names in LAUNCH_NAMES.items():
                launched[k] += any(n in name for n in names)
        busy = sum(by_class.values())
        if busy <= 0:
            raise AssertionError(f"{path}: torch.profiler recorded no kernel in a replayed step")
        launched = {k: launched[k] for k in PATHS[path]}
        if launched != PATHS[path]:
            raise AssertionError(f"{path}: kernels launched by name in a replayed step "
                                 f"{launched}, want {PATHS[path]}")
        steps.append((busy, (we - ws) / 1e3, by_class, by_name, n_name))

    def host_calls(spans):
        n = Counter()
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CPU and any(
                    e.name.startswith(h) for h in HOST_LAUNCHES) and any(
                    s <= e.time_range.start <= t for s, t in spans):
                n[e.name] += 1
        return dict(n)

    per_step = {k: v / SAMPLE_STEPS for k, v in host_calls(ranges("sampler_step")).items()}
    kernel_calls = sum(v for k, v in per_step.items() if "LaunchKernel" in k)
    if kernel_calls >= 20 or not any("GraphLaunch" in k for k in per_step):
        raise AssertionError(f"{path}: host launch calls per replayed step {per_step}")
    busy, step_wall, by_class, by_name, n_name = steps[-1]
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"path": path, "what": f"one replayed sampler step of a {SAMPLE_STEPS}-step request, "
                                  "batch 8, 256 px, bf16, alone on the device",
            "device_busy_ms_per_step": [round(s[0], 3) for s in steps],
            "step_wall_ms": [round(s[1], 3) for s in steps],
            "idle_share_per_step": [round(1 - s[0] / s[1], 4) for s in steps],
            "launches_per_step_by_name": PATHS[path],
            "host_calls_per_step": per_step,
            "host_calls_sampler_inputs": host_calls(ranges("sampler_inputs")),
            "call_wall_ms": round(wall_ms, 3),
            "sm_clock_before_after": [clock_before, clock_after],
            "ms_by_class": {k: round(v, 3) for k, v in by_class.most_common()},
            "top_kernels_ms_launches": {k: [round(v, 3), n_name[k]]
                                        for k, v in by_name.most_common(12)},
            "top_host_ops_self_ms_calls": {e.key[:60]: [round(e.self_cpu_time_total / 1e3, 3),
                                                        e.count] for e in host[:8]}}


def unet_args(B, gen, n_text=len(FLAGSHIP["ch_mult"])):
    """Inputs of one UNet forward at full width, on ``gen``'s device."""
    dev = gen.device
    text = [torch.randn(len(ARTIFACT_PROMPTS), 512, generator=gen, device=dev)
            for _ in range(n_text)]
    return (torch.randn(B, RES, RES, 1, generator=gen, device=dev),
            torch.rand(B, RES, RES, 1, generator=gen, device=dev) * 2 - 1,
            torch.full((B,), 57, dtype=torch.int32, device=dev),
            torch.arange(B, device=dev) % len(ARTIFACT_PROMPTS), text,
            torch.randn(B, 1, 512, generator=gen, device=dev))


def zero_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {k: wrapper.launches for k, wrapper in WRAPPERS.items()}


def check_graph_vs_eager(what, got, want, dtype) -> dict:
    """Graph against eager on the same inputs and generator seed: within
    1e-5 abs in fp32, ``TOL`` relative to the largest eager output in bf16."""
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    err = (got - want).abs().max().item()
    limit = 1e-5 if dtype == torch.float32 else TOL[dtype] * max(1.0, want.abs().max().item())
    if not (err <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: graph vs eager max abs err {err} > {limit}")
    return {"graph_vs_eager_max_abs_err": err, "tol": limit,
            "bit_identical": bool(torch.equal(got, want))}


def serve(path, eng, build_s, gpu) -> tuple:
    """Requests through ``Restorer.restore`` on the compiled sampler: 8
    images (the first call: warm-up and capture), 3 (padded to 8: the same
    graph), 8 again (steady state); then the first request's batch eagerly
    with the same generator seed, held against the graph's output. Each
    request's launches are counted from 0 (see the module docstring).
    Returns the launches of the graph-served requests."""
    restorer = Restorer(eng, batch_size=BATCH, sample_steps=SAMPLE_STEPS, eta=ETA, seed=0,
                        device="cuda")
    n_steps = len(strided_sampling_grid(T, SAMPLE_STEPS)[0])
    rng = np.random.default_rng(0)
    total = Counter()
    torch.cuda.reset_peak_memory_stats()
    first = None
    for n_img in (8, 3, 8):
        images = rng.uniform(-1, 1, (n_img, RES, RES, 1)).astype(np.float32)
        types = [ARTIFACT_PROMPTS[i % len(ARTIFACT_PROMPTS)] for i in range(n_img)]
        captures = eng.captures
        replays = eng.last_graph.replays if eng.last_graph else 0
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = restorer.restore(images, types)
        seconds = time.time() - t0
        got = read_launches()
        captured = eng.captures - captures
        entry = eng.last_graph
        replayed = entry.replays - (0 if captured else replays)
        per_step = {k: entry.launches[NAMES[k]] for k in PATHS[path]}
        calls = -(-n_img // BATCH)  # sampler calls: the request is chunked to the batch
        want = {k: n * (replayed + captured) for k, n in per_step.items()}
        if out.shape != images.shape or not np.isfinite(out).all():
            raise AssertionError(f"{path}, request of {n_img}: bad output {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        if (per_step != PATHS[path] or got != want or captured != (first is None)
                or replayed != n_steps * calls):
            raise AssertionError(f"{path}, request of {n_img}: launches {got} (want {want}), "
                                 f"per step at capture {per_step} (want {PATHS[path]}), "
                                 f"{captured} captures, {replayed} replays")
        total.update(got)
        if first is None:
            first = (images, types, out)
        emit({"phase": "main", "path": path, "images": n_img, "batch": BATCH, "res": RES,
              "T": T, "sampler_steps": n_steps, "eta": ETA, "dtype": "bfloat16",
              "compiled": True, "captured": bool(captured), "seconds": round(seconds, 4),
              "ms_per_step": round(seconds / n_steps / calls * 1e3, 3),
              "img_per_s": round(n_img / seconds, 4), "launches": got,
              "launches_per_step_at_capture": per_step, "graph_calls": entry.calls,
              "replays": replayed, "out_min": float(out.min()),
              "out_max": float(out.max()), "engine_build_s": round(build_s, 2),
              "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
              "gpu": gpu})
        steady_ms = seconds / n_steps / calls * 1e3
    # the first request's batch, eagerly, from the Restorer's seed
    images, types, graph_out = first
    batch = {"input": images, "type_idx": np.asarray([eng.type_map[t] for t in types]),
             "A_emb": np.zeros((BATCH, 1, eng.context_dim), np.float32)}
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    eager = eng.test(batch, torch.Generator(device="cuda").manual_seed(0), sample_steps=SAMPLE_STEPS,
                     eta=ETA, compiled=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = read_launches()
    want = {k: n * n_steps for k, n in PATHS[path].items()}
    if got != want:
        raise AssertionError(f"{path}, eager request: launches {got}, want {want}")
    emit({"phase": "main", "path": path, "what": "graph vs eager, the first request's batch, "
                                                 "same generator seed",
          **check_graph_vs_eager(f"{path} request", graph_out, eager, torch.bfloat16),
          "graph_ms_per_step_steady": round(steady_ms, 3),
          "eager_ms_per_step": round(seconds / n_steps * 1e3, 3), "eager_launches": got,
          "gpu": gpu})
    return total


def serve_full_steps(eng, gpu) -> Counter:
    """Two 8-image requests at all T=100 steps (bench.py's flagship count):
    the first captures that step count's graph, the second is steady; their
    launches, checked as ``serve`` checks them."""
    restorer = Restorer(eng, batch_size=BATCH, sample_steps=None, eta=ETA, seed=1,
                        device="cuda")
    rng = np.random.default_rng(1)
    total = Counter()
    for _ in range(2):
        images = rng.uniform(-1, 1, (BATCH, RES, RES, 1)).astype(np.float32)
        captures = eng.captures
        replays = eng.last_graph.replays
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        out = restorer.restore(images, "speckle in OCT")
        seconds = time.time() - t0
        if out.shape != images.shape or not np.isfinite(out).all():
            raise AssertionError(f"T={T} request: bad output")
        got, captured, entry = read_launches(), eng.captures - captures, eng.last_graph
        replayed = entry.replays - (0 if captured else replays)
        want = {k: entry.launches[NAMES[k]] * (replayed + captured) for k in PATHS["drift"]}
        if (got != want or replayed != T
                or any(entry.launches[NAMES[k]] != n for k, n in PATHS["drift"].items())):
            raise AssertionError(f"T={T} request: launches {got} (want {want}), "
                                 f"{replayed} replays")
        total.update(got)
        emit({"phase": "main", "path": "drift", "images": BATCH, "res": RES, "T": T,
              "sampler_steps": T, "eta": ETA, "dtype": "bfloat16", "compiled": True,
              "captured": bool(captured), "seconds": round(seconds, 4),
              "ms_per_step": round(seconds / T * 1e3, 3),
              "img_per_s": round(BATCH / seconds, 4), "launches": got, "gpu": gpu})
    return total


def compare_forwards(what, got, want, gpu) -> None:
    """(pred, score maps) against (pred, score maps), relative to the largest
    output; emits the parity line."""
    errs = []
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        err = (g - w).abs().max().item()
        limit = FORWARD_TOL * max(1.0, w.abs().max().item())
        if not (err <= limit and torch.isfinite(g).all()):
            raise AssertionError(f"{what}: err {err} > {limit}")
        errs.append(err)
    emit({"phase": "parity", "what": what, "pred_max_abs_err": errs[0],
          "scoremap_max_abs_err": max(errs[1:]), "pred_max_abs": want[0].abs().max().item(),
          "tol_rel": FORWARD_TOL, "gpu": gpu})


# fused-conv launch shapes (H, W, C, Cout) of one flagship forward, for --sweep
SWEEP_SHAPES = [(256, 256, 64, 64), (256, 256, 64, 5), (256, 256, 144, 64), (128, 128, 64, 128),
                (128, 128, 128, 128), (128, 128, 272, 128), (64, 64, 128, 256),
                (64, 64, 256, 256), (64, 64, 528, 256), (32, 32, 256, 256), (32, 32, 528, 256)]


def sweep_conv(gpu) -> None:
    """Time the bf16 conv kernel at each flagship launch shape (batch 8) under
    every tile / N-block choice its plan picks from, beside cuDNN's conv on
    the normalised input; one JSON line per shape (ms, median of 10)."""
    lib = _build.load("fused_gn_silu_conv3x3")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for H, W, C, Cout in SWEEP_SHAPES:
        shape = (BATCH, H, W, C, Cout, False)
        x, scale, shift, w, bias, _ = conv_case(shape, torch.bfloat16, gen)
        out = torch.empty(BATCH, H, W, Cout, device="cuda", dtype=torch.bfloat16)
        want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias)
        xn = torch.nn.functional.silu(
            x.float() * scale[:, None, None] + shift[:, None, None]).bfloat16().permute(0, 3, 1, 2)
        wk = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        plan = conv_plan(BATCH, H, W, C, Cout)
        row = {"phase": "sweep", "shape": [BATCH, H, W, C, Cout],
               "plan": f"{plan['th']}x{plan['tw']} nb{plan['nb']}",
               "cudnn_ms": cuda_ms(lambda: torch.nn.functional.conv2d(xn, wk, padding=1))}
        for th in (16, 8):
            for nb in sorted({plan["nb"], 64, 128, 256}):
                if nb > max(64, 2 * Cout) or (nb == 8) != (Cout <= 8):
                    continue
                wpk = pack_weights(w, nb)

                def run():
                    _build.check(lib.fgc_tc_forward(
                        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wpk.data_ptr(),
                        bias.data_ptr(), None, out.data_ptr(), BATCH, H, W, C, Cout, th, nb,
                        plan["stages"], torch.cuda.current_stream().cuda_stream), "sweep")

                run()
                check_err(f"sweep {row['shape']} {th}x8 nb{nb}", out, want, torch.bfloat16)
                row[f"{th}x8 nb{nb}"] = cuda_ms(run)
        emit(dict(row, gpu=gpu))


# GroupNorm launch shapes (H, W, C, G) of the flagship drift and DDPM forwards
GN_SWEEP_SHAPES = [(256, 256, 64, 32), (256, 256, 144, 24), (128, 128, 64, 32),
                   (128, 128, 128, 32), (128, 128, 256, 32), (128, 128, 272, 17),
                   (64, 64, 128, 32), (64, 64, 256, 32), (64, 64, 512, 32), (64, 64, 528, 24),
                   (32, 32, 256, 32), (32, 32, 512, 32), (32, 32, 528, 24)]


def sweep_gn(gpu) -> None:
    """Time the bf16 GroupNorm kernels at each flagship launch shape (batch 8)
    on both paths: the two launches, and the cluster launch where an image
    fits; beside ``F.group_norm`` + ``F.silu``; and the statistics launch
    alone (``gn_channel_affine``). One JSON line per shape: ms (CUDA events
    around one call, host time included) and device ms (profiler). Then the
    host time per call of the two wrappers beside one small aten launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    for H, W, C, G in GN_SWEEP_SHAPES:
        HW = H * W
        x, gamma, beta = gn_case(BATCH, H, W, C, dt, gen)
        want = group_norm_silu_plain(x, gamma, beta, G)
        want_affine = gn_channel_affine_plain(x, gamma, beta, G)
        xn = x.permute(0, 3, 1, 2)
        plan = gn_plan(BATCH, HW, C, G)
        row = {"phase": "sweep_gn", "shape": [BATCH, H, W, C, G],
               "plan": f"{plan['path']} cs{plan['cluster']}",
               "bound_ms": gn_cost((BATCH, H, W, C, G, True), dt)[0],
               "affine_bound_ms": affine_cost((BATCH, H, W, C, G), dt)[0],
               "library_ms": cuda_ms(lambda: torch.nn.functional.silu(
                   torch.nn.functional.group_norm(xn, G, gamma.to(dt), beta.to(dt), 1e-5)))}
        choices = ["two_launch"]
        if cluster_smem_bytes(-(-HW // CLUSTER), C, G, 8, 2) <= SMEM_LIMIT:
            choices.append("cluster")
        for name in choices:
            p = gn_plan(BATCH, HW, C, G, 2, cluster=CLUSTER if name == "cluster" else 0)

            def run():
                return group_norm_silu_cuda(x, gamma, beta, G, plan=p)

            check_err(f"sweep_gn {row['shape']} {name}", run(), want, dt)
            row[name] = [cuda_ms(run), device_ms(run, "gn")]

        def run_affine():
            return group_norm_affine_cuda(x, gamma, beta, G)

        for got, w in zip(run_affine(), want_affine):
            check_err(f"sweep_gn affine {row['shape']}", got, w, torch.float32)
        row["affine"] = [cuda_ms(run_affine), device_ms(run_affine, "affine")]
        emit(dict(row, gpu=gpu))
    # host time per call (microseconds, 200 calls back to back at a small
    # shape whose kernels take less time than the host needs to launch them)
    x, gamma, beta = gn_case(1, 8, 8, 64, dt, gen)

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    emit({"phase": "sweep_gn_host", "shape": [1, 8, 8, 64, 32], "us_per_call": {
        "group_norm_silu": host_us(lambda: group_norm_silu(x, gamma, beta, 32)),
        "gn_channel_affine": host_us(lambda: gn_channel_affine(x, gamma, beta, 32)),
        "x.add(1) (one small aten launch)": host_us(lambda: x.add(1))}, "gpu": gpu})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    gpu = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)

    # 1. build
    t0 = time.time()
    logs = _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    spills, regs = ptxas_report(logs)
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "gpu": gpu,
          "kernels": list(_build.SIGNATURES), "ptxas": ptxas, "spill_bytes": spills,
          "registers": regs})
    spilled = {k: v for k, v in spills.items() if v and any(t in k for t in NO_SPILL)}
    if spilled:
        raise AssertionError(f"tensor-core kernels spill registers: {spilled}")

    args = sys.argv[1:]
    if "--sweep" in args:
        which = set(args) & {"conv", "gn"} or {"conv", "gn"}
        if "gn" in which:
            sweep_gn(gpu)
        if "conv" in which:
            sweep_conv(gpu)
        return 0

    # 2. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = Counter()
    for dtype in (torch.bfloat16, torch.float32):
        for kname, shapes in (("conv", CONV_SHAPES), ("flash", FLASH_SHAPES),
                              ("gn", GN_SHAPES), ("affine", AFFINE_SHAPES)):
            for shape in shapes:
                m = MEASURE[kname](shape, dtype, gen)
                if dtype == torch.bfloat16:
                    worst[kname] = max(worst[kname], m["max_abs_err"])
                emit({"phase": "check", "kernel": NAMES[kname], "shape": shape,
                      "dtype": str(dtype), "tol": TOL[dtype], **m, "gpu": gpu})

    # 3. the main paths at full width: requests through Restorer.restore on
    # the compiled sampler, against the eager loop
    launches = Counter()
    shapes = {}
    for path, make in (("drift", lambda: flagship_engine(torch.bfloat16)),
                       ("drift_unfused",
                        lambda: flagship_engine(torch.bfloat16, {"fused_gnconv": False})),
                       ("ddpm", lambda: ddpm_engine(torch.bfloat16))):
        t0 = time.time()
        eng = make()
        torch.cuda.synchronize()
        build_s = time.time() - t0
        net_key, n_text = ("n_ema", 1) if path == "ddpm" else ("d_ema", len(FLAGSHIP["ch_mult"]))
        shapes[path] = record_launch_shapes(eng.nets[net_key], unet_args(BATCH, gen, n_text))
        launches.update(serve(path, eng, build_s, gpu))
        if path == "drift":
            launches.update(serve_full_steps(eng, gpu))
        emit({"phase": "profile", **profile_step(eng, gen, path), "gpu": gpu})
        del eng
        torch.cuda.empty_cache()

    # 4. full-width fp32: sampler calls replayed from the graph against the
    # eager loop; UNet forwards, kernels vs plain versions, both bodies
    def fp32_graph_vs_eager(what, eng):
        # cuDNN's default algorithm for the decoder's transposed convs is not
        # deterministic in fp32, so the eager loop differs from itself (the
        # DDPM step at t=T divides by sqrt(abar_T) = 1e-4); the comparison
        # holds every op to a deterministic algorithm, and the eager loop's
        # own spread without that is printed beside it
        batch = {"input": np.random.default_rng(2).uniform(-1, 1, (2, RES, RES, 1)).astype(
            np.float32), "type_idx": np.array([0, 3])}

        def run(compiled):
            return eng.test(batch, torch.Generator(device="cuda").manual_seed(3),
                            sample_steps=2, eta=0.0, compiled=compiled)

        spread = (run(False) - run(False)).abs().max().item()
        torch.backends.cudnn.deterministic = True
        got, want = run(True), run(False)
        torch.backends.cudnn.deterministic = False
        emit({"phase": "parity", "what": what + " (cudnn.deterministic)",
              "captures": eng.captures, **check_graph_vs_eager(what, got, want, torch.float32),
              "eager_vs_eager_default_cudnn_max_abs_diff": spread, "gpu": gpu})

    eng32 = flagship_engine(torch.float32)
    fp32_graph_vs_eager("drift sampler, fused body, fp32, batch 2, 2 steps, eta 0: graph vs "
                        "eager", eng32)
    net = eng32.nets["d_ema"]
    args = unet_args(2, gen)
    out = {}
    with torch.inference_mode():
        for body in ("fused", "unfused"):
            net.use_fused_gnconv = body == "fused"
            out[body] = net(*args)
            with contextlib.ExitStack() as stack:
                for patch in plain_kernels():
                    stack.enter_context(patch)
                out[body + "_plain"] = net(*args)
    compare_forwards("drift UNet forward, fused body, kernels vs plain, fp32, batch 2",
                     out["fused"], out["fused_plain"], gpu)
    compare_forwards("drift UNet forward, unfused body, kernels vs plain, fp32, batch 2",
                     out["unfused"], out["unfused_plain"], gpu)
    compare_forwards("drift UNet forward, unfused vs fused body, kernels, fp32, batch 2",
                     out["unfused"], out["fused"], gpu)
    del eng32, net, out
    torch.cuda.empty_cache()
    eng32 = ddpm_engine(torch.float32)
    fp32_graph_vs_eager("DDPM sampler, fp32, batch 2, 2 steps, eta 0: graph vs eager", eng32)
    args = unet_args(2, gen, n_text=1)
    with torch.inference_mode():
        got = eng32.nets["n_ema"](*args)
        with contextlib.ExitStack() as stack:
            for patch in plain_kernels():
                stack.enter_context(patch)
            want = eng32.nets["n_ema"](*args)
    compare_forwards("DDPM UNet forward, kernels vs plain, fp32, batch 2", got, want, gpu)
    del eng32, got, want
    torch.cuda.empty_cache()

    # 5. every kernel of every path, per UNet forward at that path's own
    # launch shapes; the kernels line takes the first path that launches it
    entries = {}
    for path, per_step in PATHS.items():
        for kname in (k for k, n in per_step.items() if n):
            tot = Counter()
            bound_by = Counter()
            per_shape = []
            for (shape, dtype), count in shapes[path][kname].items():
                m = MEASURE[kname](shape, dtype, gen)
                per_shape.append([list(shape), count, round(m["ms"], 4),
                                  round(m["device_ms"], 4), round(m["bound_ms"], 4),
                                  round(m["library_ms"], 4)]
                                 + ([round(m["tflops"], 2)] if "tflops" in m else [])
                                 + ([m["path"]] if "path" in m else []))
                for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                    tot[key] += m[key] * count
                bound_by[m["bound_by"]] += m["bound_ms"] * count
                tot["max_abs_err"] = max(tot["max_abs_err"], m["max_abs_err"])
            emit({"phase": "per_forward", "kernel": kname, "path": path,
                  "launches_per_forward": sum(shapes[path][kname].values()),
                  "distinct_shapes": len(per_shape), **{k: round(v, 4) for k, v in tot.items()},
                  "shapes_count_ms_device_bound_library"
                  + {"conv": "_tflops", "gn": "_path"}.get(kname, ""): per_shape, "gpu": gpu})
            worst[kname] = max(worst[kname], tot["max_abs_err"])
            entries.setdefault(kname, {
                "name": NAMES[kname], "route": "cuda", "source": SOURCES[kname][0],
                "replaces": SOURCES[kname][1], "launches": launches[kname],
                "ms": tot["ms"], "device_ms": tot["device_ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"], "bound_by": bound_by.most_common(1)[0][0],
                "library_ms": tot["library_ms"], "library": LIBRARY[kname]})
    entries = [dict(e, max_abs_err=worst[k]) for k, e in entries.items()]
    emit({"kernels": entries})
    print(gpu, flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
