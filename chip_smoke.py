"""Drive the PyTorch port on one CUDA card and hold its kernels against their
plain PyTorch versions.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --sweep [conv|gn|flash]`` builds the kernels and
only times plan choices at each flagship launch shape: the bf16 fused conv
under each tile / N-block choice and the fp32 one under each N block,
beside cuDNN; the GroupNorm kernels on the two-launch path and the cluster
path (8 blocks per image) beside ``F.group_norm`` + ``F.silu``; the fp32
flash kernel with 4 and 8 warps per block beside SDPA; all three without
an argument. ``python3 chip_smoke.py --fp32-request ROOT [ROOT ...]`` runs
only the served fp32 request of phase ``bundle`` on the package of each
tree given, in turn, e.g. an unpacked parent commit and ".", to read the
request before and after a change in one call.)

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
                per call from torch.profiler's records, the mean over a
                window's launches; every call on a cold L2), the conv's
                achieved TFLOP/s, plain ms, one library call's ms (a
                yardstick only: the port never calls it) and the bound:
                bytes at 3.35
                TB/s or operations at 989 TFLOP/s (bf16) and, for the fp32
                fused conv and flash, at the split-TF32 rate 495/3 = 165
                TFLOP/s (``TC_FLOPS``; the GroupNorm kernels' fp32 work at
                67 TFLOP/s), the larger; then the flash kernel at every
                head width it takes (4 to 128, and 96 for
                coca_ViT-L-14's pooler; fp32, bf16 and fp16,
                [8,4,1024,D]) with the kernel and warps the plan picks,
                here, before the main paths: later, torch.profiler
                undercounts the kernel libraries' launches;
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
                then phase ``gaps`` (3a. below), then phase ``per_forward``
                (6. below) on the three paths'
                launch shapes, and then ``profile``: one request's replayed
                steps per path, each alone on the device (a synchronise
                before and after each replay), under torch.profiler: per
                replayed step the device time by kernel class, the device's
                idle share, the launches of each kernel counted by name over
                the replays against steps x the per-step counts, and the
                host's kernel and graph launches per step (the call's text
                encodings counted apart); the SM clock before and after;
  3a. gaps  -- on main's flagship bf16 drift engine: an 8-image, 4-step
                request on the compiled sampler (256 px); then
                ``engine.set_sde`` to a DriftSDE with another max_sigma
                (``GAPS_SIGMA``) and the same T, and the request again: it
                must capture anew (``captures`` + 1), give the same engine's
                eager output on the new SDE within the ``parity`` rule
                (``check_graph_vs_eager``), differ from the old SDE's output,
                and ``get_visuals()`` must equal what it returned; its
                launches (replays, warm-up, eager) held to ``PATHS["drift"]``
                and counted in the kernels line; then ``ops.resize.resize_like``
                at every ``jax.image.resize`` method name on the card against
                the CPU, within 1e-5 in fp32; the engine gets its SDE back;
  4. parity  -- full-width fp32 sampler calls (batch 2, 2 steps, eta 0)
                replayed from the graph against the eager loop (1e-5 abs),
                drift and DDPM; then UNet forwards (fp32, batch 2) through
                the kernels and through the plain versions, compared: the
                drift net on the fused body, on the unfused body, the
                unfused body against the fused one on the same weights, and
                the DDPM net;
  5. bundle  -- the path config -> bundle -> compiled sampler -> metrics at
                Configurations/flagship_test.yml's width (224 px, bf16, in a
                temporary directory): a seeded engine of the config is saved
                (``engine.save``: the bundle and the text tower's sidecar;
                bytes and seconds), served by ``Restorer.from_config`` (load
                seconds) with one 8-image request of 4 steps that must be
                bit-identical to the in-memory engine's on the same
                generator seed, with (steps + 1) x ``PATHS["drift"]``
                launches; then the golden of tests/data_torch/tiny_bundle:
                its bundle rebuilt from the seed by the port's codec must
                hash as the files JAX wrote, and served through
                ``from_config`` in fp32 (cuDNN deterministic) with the
                golden's noise it must give JAX's output within
                ``TOL[fp32]``, its launches checked in its own line; then
                ``tools/testUM`` over a SpeckleMed dataset of numpy
                phantoms (2 per artifact type, batch 5): per-type
                RMSE/SSIM/PSNR and each batch's sampler seconds (a smoke
                reading: the first batch captures the step); last, the
                config at its own dtype, fp32 (``fp32_request``): a seeded
                fp32 engine saved and served by ``from_config``, 5 images
                at 224 px, 4 steps, twice (capture, replay): ms per step of
                the replaying request and the launches, on the split-TF32
                fused conv and flash kernels;
  5b. breadth -- on phase ``bundle``'s bundle and phantoms: (a)
                ``tools/testUM --knob fused_gnconv=0`` (an unknown knob must
                raise before any batch; the per-step launches at capture
                ``PATHS["drift_unfused"]``; per-type RMSE/SSIM/PSNR beside
                the fused run's; the restored images within
                ``BF16_FORWARD_TOL`` of the fused run's); (b) the UNet
                without SMM text conditioning (``create_net`` on
                flagship_tpu.yml's ``nnet_settings`` with ``text_module:
                none``), one forward at bf16, batch 8, 256 px and one at
                fp32, batch 2, on each body, through the kernels against the
                plain versions, with launches per forward and its new conv
                shapes (held in ``check``); (c) ``utils.tracing``: three
                requests timed by a ``StepTimer``, then one replayed request
                inside ``trace()`` under ``annotate()``: the exported Chrome
                trace must hold the annotation and each kernel by name,
                steps x its per-step count, and ``device_memory_stats()``;
                (d) ``utils.metrics.psnr_tensor``/``ssim_tensor`` on (a)'s
                outputs on the card against the host's
                ``eval_restoration`` (``METRIC_TOL``). (a)'s and (c)'s
                launches count in the ``kernels`` line;
  6. per_forward -- (right after the main requests, before ``profile``)
                every kernel each main path launches, held against its
                plain version and timed at that path's own launch shapes
                (bf16, batch 8), summed over one UNet forward (ms and
                device_ms; each call on a cold L2, ``flush_l2``; a profiler
                window that lost records is taken again, and a ``profiler``
                line reports the loss); then, after phase ``dist``, the
                ``{"kernels": [...]}`` line (each
                kernel's times from the first path that launches it:
                fused-conv, flash and gn_channel_affine from drift, GroupNorm
                from drift_unfused; max_abs_err over every shape),
                the card's name and power limit, and last
                ``{"ok": true, "device": {...}}``. A kernel's ``launches`` are
                its wrapper's counts over the graph-served main requests,
                the bundle phase's flagship-width runs (the
                ``from_config`` requests in bf16 and fp32 and testUM, and
                the breadth phase's testUM and traced requests; not
                the golden, whose
                config and fp32 are not a main path's) and the encoders
                phase's requests and precompute_embeddings: the warm-up
                steps' launches plus, per replay, the per-step count recorded at capture
                (the eager comparison is counted apart); ``profile`` counts
                the replayed kernels by name on the device and holds them to
                the same per-step counts.

  6b. encoders -- the conditioning encoders at full width, seeded random
                weights: the flash kernel at the ViT-B/16 tower's shapes
                ([8,12,197,64] and [8,12,257,64] fp32, [8,12,197,64] bf16)
                against its plain version with bound and SDPA's time; the
                on-device image context: a bf16 flagship_test.yml bundle and
                a ViT-B/16 (fp32) written as image_params.ckpt, served by
                ``Restorer.from_config`` with ``test.on_device_emb`` (requests
                of 8, 3 and 8 at 4 steps through the graph, one eager; each
                call's 12 tower flash launches held beside the steps'), the
                embeddings' norms, the tower against itself on the plain
                attention, its ms per call and device busy, a request with
                the tower and one with ``A_emb`` given; ``CLIP_Type:
                BiomedCLIP`` at the flagship's widths (256 px, batch 8,
                bf16, the 12-layer PubMedBERT tower): drift requests at 4
                steps and two at T=100, the per-call text encodings profiled,
                DDPM requests, one drift train step; then
                ``tools/precompute_embeddings`` on a seeded ViT-B/16 open_clip
                state dict and 10 phantoms, each file held to the tower run
                directly. Its graph-served runs and the tool count in the
                kernels line: the steps' in the kernels' rows, the image
                tower's flash launches (fp32) and its shapes' timings and
                errors in the flash row's field ``image_tower``, its errors
                in the row's ``max_abs_err`` too. It runs after
                ``per_forward``'s timings
                (its profiles record kernels before its train step);
  6c. towers -- (after ``encoders``, before ``train``) the tower breadth at
                full width, seeded random weights in each checkpoint's own
                key layout written to a temporary directory: (a)
                ``load_openai_model`` on an OpenAI RN50 (layers (3,4,6,3),
                width 64, embed 1024, text width 512; ``torch.save``d) and
                an OpenAI ViT-B/16 (``torch.save``d and ``torch.jit.save``d,
                the archive's embeddings equal to the state dict's): 8
                images at 224 px and the 5 prompts on the card against the
                CPU in fp32 (``FORWARD_TOL``), 1 flash launch per RN50
                ``encode_image`` (the attention pool, [8,32,50,64]) and 12
                per ViT; (b) BiomedCLIP (ViT-B/16, PubMedBERT) at fp16 and
                pure_fp16 against its fp32 run of the same weights
                (``FP16_TOL``), 12 fp16 flash launches per ``encode_image``;
                (c) ``CLIPDenseVisionTransformer`` ViT-B/16 with the patch-16
                necks and embeddings, batch 8, at 224 and 320 px (the
                bilinear position resize), then ``ContextDecoderRef`` (width
                256, 6 layers, unscaled and scaled; 6 flash launches of
                [8,4,5,64]) and ``ContextDecoder`` (512, 3 layers, no flash)
                on its maps with 5 text queries, each against the CPU in
                fp32; (d) one train-mode ViT-B/16 forward (PatchDropout 0.5,
                DropPath 0.1) from a seeded CUDA generator: 99 tokens kept,
                the same seed the same output. Then every distinct flash
                launch of (a)-(c) held against its plain version and timed,
                one ``per_forward`` line per tower path. ``check`` holds the
                fp16 instantiation at [8,4,1024,D] for every D and at
                ``FLASH_FP16_SHAPES``; the kernels line's flash row gains
                ``towers`` (the phase's launches by dtype and its shapes'
                measurements) and ``fp16`` (its launches and its check);
  6d. coca -- (after ``towers``, before ``train``) CoCa at full width,
                seeded random weights: (a) coca_ViT-B-32 (JAX's defaults,
                fp32) written as an open_clip state dict (1.0 GB) to a
                temporary file and read back through the registry's
                converter (``pretrained.resolve_converter`` ->
                ``coca.load_torch_coca_weights``) on the card and on the
                CPU, every parameter equal to the one written; its forward
                on 8 one-channel 224 px images and ids [8, 76] through the
                kernels (13 flash launches per ``encode_image``: 12 blocks
                and the pooler's 256 queries over 50 keys; 12 per decoder
                pass, 76 queries over 255 keys), against plain flash
                (``TOL``) and the CPU (``FORWARD_TOL``); (b) captions of 30
                tokens: greedy (against the plain-flash run: the step logits
                within ``TOL``, the tokens equal or the first difference's
                top-2 margin below the logits' error), top-p from a seeded
                generator, beam search (6 beams in 3 groups), each held to
                the fixed-shape EOS/PAD contract, ms per caption; (c) the
                forward in bf16 against the fp32 one (latents within
                ``FP16_TOL``; logits within ``BF16_FORWARD_TOL`` or 1.5x the
                plain-flash bf16 run's distance); (d) coca_ViT-L-14's widths
                at full depth (24 vision layers of 1024, the pooler's 8 heads
                96 wide over 257 keys), seeded on the card: ``encode_image``
                and ``decode`` in fp32 and bf16 against plain flash; then
                every distinct flash launch (Nq, Nk apart) held against its
                plain version and timed, a ``per_forward`` line per path, and
                the pooler's shape in fp16. The kernels line's flash row
                gains ``coca`` (launches by dtype, the shapes' measurements);
  7. train  -- ``tools/trainUM`` at flagship width (224 px, batch 4) over
                SpeckleMed phantoms: drift fp32 (``flagship_tpu.yml``, remat
                on) 6 iterations (cut from 12, then 8, for the script's
                time) with checkpoints at 3 and 6 and inline validation at
                6, resumed from 3 (no validation or
                checkpoint before its end) and held equal to the
                uninterrupted run (nets, EMA, Adam moments), these two runs
                alone under cuDNN deterministic; its bundle served by
                ``Restorer.from_config``; the sampler's graph captured anew
                after one more step and held to the eager loop; then, at
                PyTorch's defaults, steps timed with remat on and off; drift
                bf16 and DDPM 4 iterations each, validated inline; one step
                of each profiled (the idle share against the profiled
                step's wall and against the unprofiled median); ms per step
                (median after 2 warm-up steps), img/s, peak memory and the
                first and last losses; then one drift step at nf 64, ch_mult
                [1,2], 64 px on the card against the CPU (TF32 off). The
                train steps launch no kernel; validation and serving launch
                ``PATHS``' per-step counts, and the phase's launches are
                printed in its own line, not in the ``kernels`` line (its
                runs are fp32 or batch 1-2, not the main paths' shapes). A
                smoke reading, not a rate. It runs after ``per_forward``'s
                timings (after its profiles of train steps torch.profiler
                recorded no kernel of the kernel libraries on the card).
  8. distill -- (a) ``tools/distill``
                at flagship_bf16_tpu.yml's widths (224 px, batch 4) on a
                seeded bundle, phases 50 and 25 of 4 steps each: per phase
                the median ms per distill step after 2 warm-ups, the
                teacher's two predictions' ms (CUDA events), launches per
                step (twice the drift path's per-step counts: the teacher's
                rollout runs the kernels), peak memory, losses; the
                teacher's composed targets on the kernels against the plain
                path (an fp32 copy of the teacher held within ``TOL``, the
                bf16 teacher's error read); ``distill25`` served by ``Restorer.from_config`` at 25
                steps, eta 0 on the compiled sampler (bit-identical to the
                eager loop); the tool's student recaptured after one more
                distill step; (b) on weights that learned, nf 16 (8-wide
                heads), fp32: ``demo_all_modalities`` (every modality
                restored >= degraded + 6 dB; in a process of its own,
                run beside phases ``irsde`` and ``dist``), JAX's
                distillation gate (the
                fixture recipe's teacher, one phase T=16 -> 8: the student
                >= degraded + 6 dB and within 1 dB of the teacher), and
                ``eval_protocol`` tables for both on a port Synthetic set
                pinned by its manifest (the gate and its tables in a process
                of their own, ``start_gate``, run beside phase ``train``,
                whose host-bound readings then share the host). Its
                launches are printed in a line of its own, not in the
                ``kernels`` line.
  9. irsde  -- ``create_sde({"class_name": "IRSDE", "T": 12})`` (cut from
                the config's T=100 for the script's time) driven by
                two noise predictors with seeded random weights, each on the
                kernels and on the plain path: the DDPM net at
                flagship_ddpm_tpu.yml's widths (unfused body: 45
                ``group_norm_silu`` + 1 flash per step) and the flagship drift
                engine's noise net (fused body: 45 fused conv + 45
                ``gn_channel_affine`` + 1 flash); 256 px, batch 8, bf16:
                ``reverse_sde`` (stochastic, injected noise) and
                ``reverse_ode`` at all 12 steps, kernels vs plain within
                ``TOL[bf16]`` of the plain result's largest value, launches
                per step held to ``IRSDE_PATHS``, ms per step; then
                ``ode_sampler`` in fp32 (rtol = atol = 1e-5) at
                ``IRSDE_ODE_RES`` px on both paths (evaluations, accepted and
                rejected steps, launches per evaluation; kernels vs plain
                within ``IRSDE_ODE_TOL`` of the largest value plus twice the
                solve's own error, the kernels' distance to their solve at a
                tenth of the tolerance). Its kernel launches count in the
                ``kernels`` line. Phase ``dist``'s (a) runs beside it, in
                the background, so its ms per step read a shared host;
 10. dist   -- (a) ``tools/trainUM`` with ``train.dist: true`` launched by
                ``python -m torch.distributed.run --nproc_per_node 1`` with
                ``--launcher pytorch`` (one NCCL rank) at
                flagship_bf16_tpu.yml's widths, 224 px, batch 4, 2
                iterations, validated and saved at the end, against the
                same run without a process group, both cuDNN deterministic
                (the two run at once, beside phase ``irsde``): the bundle
                and ``{iter}.state`` must hash alike; NCCL with two
                ranks on the card (reported: NCCL takes one rank per card);
                (b) two spawned ranks sharing the card over gloo at
                flagship_tpu.yml's widths (fp32, remat), 224 px, global batch
                4 (2 per rank), 2 steps on one set of injected draws: the
                first step's averaged gradients and updated parameters held
                to one process's step on the global batch (the rules of
                ``grad_check``), the ranks' parameters equal, ms per step
                per rank, the all-reduce's ms and bytes.
 11. spatial -- two spawned gloo ranks sharing the card serve the flagship
                drift sampler at full width (seeded random weights) through
                ``Restorer(spatial=2)``: the images' height split over the
                ranks (halo rows exchanged around every 3x3 conv, GroupNorm
                statistics summed over the ranks by the sharded entries
                ``gn_partial_sums`` / ``gn_apply`` of the GroupNorm kernels,
                the bottleneck's local queries, Nq = N / 2, on the flash
                kernel against the keys of both ranks, Nk = N), eagerly:
                512 px, batch 2, 2 steps (cut from 4 for the script's time),
                eta 0, fp32 and bf16 (fused body),
                and 256 px, 2 steps, fp32 on the unfused body; each against
                the same request unsharded on the card (fp32 within
                ``SPATIAL_TOL_FP32``, bf16 within ``TOL`` of the largest
                output); launches per rank (every kernel of the path must
                launch), the flash launches' Nq / Nk, seconds; then rank 0
                holds ``gn_partial_sums`` and ``gn_apply`` against their
                plain versions and times them at the shapes the sharded
                path gave them (the kernels line's two sharded entries);
                and ``tools/restore --spatial 2`` (``SPATIAL_RESTORE``:
                flagship_tpu.yml's net seeded as ``flagship_engine``'s, 256
                px, 2 images, 2 steps; rank 0 alone writes) against the same
                command unsharded, within ``SPATIAL_TOL_FP32``;
 12. fsdp   -- two spawned gloo ranks sharing the card on a 1 x 2 dp x fsdp
                grid (``engine.shard_fsdp``: parameters, Adam's moments and
                the EMA shadows split over the ranks, gathered for each
                forward) take dist (b)'s two fp32 steps at 224 px on the
                whole batch of 4, against one process's steps: the losses
                within ``GRAD_TOL``, the first moments by ``check_grads``;
                the bytes of train state each rank holds against unsharded,
                ms per step.

Any failure raises and the script exits non-zero; a failed capture too (the
engines never fall back to the eager loop). Without CUDA it exits 1 before
doing anything."""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
import yaml

from instancediff_torch import parallel
from instancediff_torch.config import load_options
from instancediff_torch.models import create_model
from instancediff_torch.models import unet as unet_mod
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.models.engine import ARTIFACT_PROMPTS, KERNELS, TEXT_SIDECAR
from instancediff_torch.models.layers import ConvParams, cast_compute_
from instancediff_torch.models.modules import create_net
from instancediff_torch.ops import _build
from instancediff_torch.ops.flash_attention import (HEAD_WIDTHS, flash_attention,
                                                     flash_attention_plain, flash_plan)
from instancediff_torch.ops.fused_gn_conv import (conv_plan, fused_gn_silu_conv3x3,
                                                  fused_gn_silu_conv3x3_plain, gn_channel_affine,
                                                  gn_channel_affine_plain, pack_weights)
from instancediff_torch.ops.group_norm_silu import (CLUSTER, SMEM_LIMIT, cluster_smem_bytes,
                                                    gn_plan, group_norm_affine_cuda,
                                                    group_norm_silu, group_norm_silu_cuda,
                                                    group_norm_silu_plain)
from instancediff_torch.sde import DDPMSDE, DriftSDE, create_sde
from instancediff_torch.sde.schedules import strided_sampling_grid
from instancediff_torch.serving import Restorer
from instancediff_torch.tools import testUM, trainUM
from instancediff_torch.utils import checkpoint as ckpt
from instancediff_torch.utils import metrics, tracing
from instancediff_torch.utils.convert import flax_params, load_flax_params
from instancediff_torch.utils.metrics import eval_restoration
from instancediff_torch.utils.parity import check_grads, check_params

# H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s by operand type
# (bf16 on the tensor cores; fp32 on the FMA units, which the GroupNorm
# kernels use); the fused conv and flash take fp32 on the tensor cores in
# split TF32, three TF32 products per fp32 product: 495 / 3 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
TC_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 495e12 / 3}
# kernel vs plain on the card: max |diff| <= TOL * max(1, max |plain|).
# fp32: the same fp32 arithmetic in another summation order. bf16: both
# round the activation and the result to bf16, so a result may differ by one
# bf16 ulp (2^-8 relative) where the fp32 sums straddle a rounding boundary.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}
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
    (8, 28, 28, 528, 256, False), (8, 56, 56, 272, 128, False), (8, 64, 64, 20, 5, False),
    # the SMM-less UNet's first decoder block of each level (no score-map
    # channels: 144 -> 128, 272 -> 256, 528 -> 512 wide)
    (8, 256, 256, 128, 64, False), (8, 128, 128, 256, 128, False),
    (8, 64, 64, 512, 256, False), (8, 32, 32, 512, 256, False)]
# the bottleneck at 256 and 224 px, the ViT-B/16 tower at 224 and 256 px, and
# coca_ViT-L-14's attentional pooler ([B, H, Nq, Nk, D]: 256 queries in 8
# heads of 96 over 1 + 16x16 image tokens)
FLASH_SHAPES = [(8, 4, 1024, 64), (8, 4, 784, 64), (8, 12, 197, 64), (8, 12, 257, 64),
                (8, 8, 256, 257, 96)]
# fp16 (BiomedCLIP at fp16 / pure_fp16): the ViT-B/16 tower's shapes and
# OpenAI RN50's attention pool (32 heads of 64 over 1 + 7x7 tokens); the
# coca_ViT-L-14 pooler's
FLASH_FP16_SHAPES = [(8, 12, 197, 64), (8, 12, 257, 64), (8, 32, 50, 64), (8, 8, 256, 257, 96)]
GN_SHAPES = [  # (B, H, W, C, groups, silu)
    (8, 256, 256, 64, 32, True), (8, 256, 256, 144, 24, True), (8, 128, 128, 272, 17, True),
    (8, 64, 64, 528, 24, True), (8, 32, 32, 512, 32, True),
    # the SMM-less UNet's GroupNorm over [h, skip] (32 groups)
    (8, 256, 256, 128, 32, True), (8, 128, 128, 256, 32, True), (8, 64, 64, 512, 32, True)]
AFFINE_SHAPES = [  # (B, H, W, C, groups); C = 20 with odd H and W: the one-element path
    (8, 256, 256, 64, 32), (8, 256, 256, 144, 24), (8, 128, 128, 272, 17), (8, 64, 64, 528, 24),
    (8, 32, 32, 256, 32), (3, 19, 23, 20, 5),
    # the SMM-less UNet's statistics over [h, skip]
    (8, 256, 256, 128, 32), (8, 128, 128, 256, 32), (8, 64, 64, 512, 32), (8, 32, 32, 512, 32)]
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
# the instruction runs would be lost, and a spilled mma.sync fragment or
# accumulator costs local-memory traffic on every tile
NO_SPILL = ("fgc_tc_kernel", "fgc_tf32x3_kernel", "flash_tc_kernel", "flash_tf32x3_kernel")


def ptxas_report(logs) -> tuple:
    """({entry: spill stores + loads in bytes}, {entry: registers}) per
    compiled entry (the start of its mangled name), from nvcc's ``-Xptxas
    -v`` output."""
    spills, regs, entry = {}, {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:  # from the kernel's own name on (fgc_..., flash_..., gns_...): the
                # last match, past the anonymous namespace's file tag
                # (..._flash_attention_cu_...), so each instantiation is its own
                name = m.group(1)
                entry = name[[k.start() for k in re.finditer(r"(fgc|flash|gns)_", name)][-1]:][:48]
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


# the H100's L2 holds 50 MB: a write of FLUSH_BYTES between timed calls
# evicts what the previous call left there, so each timed call reads its
# inputs from HBM, as a forward finds the activations of the layer before a
# level's worth of other work back
FLUSH_BYTES = 256 << 20


@functools.lru_cache(maxsize=1)
def flush_buffer() -> torch.Tensor:
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")


def flush_l2() -> None:
    """Overwrite the L2 with ``FLUSH_BYTES`` (a fill kernel, which the
    device-time sums leave out by name)."""
    flush_buffer().fill_(0.0)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls,
    each call on a cold L2 (``flush_l2`` before its start event)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush_l2()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kname: str, per_call: int = 1, reps: int = 10, attempts: int = 5) -> float:
    """Device time per call of ``fn`` spent in kernel ``kname``'s own CUDA
    kernels (names in ``KERNEL_CLASSES``), from torch.profiler over ``reps``
    calls after a warm-up, each call on a cold L2 (the flush's fill kernel is
    not summed): the kernel time without the host's. ``per_call`` is the
    number of distinct kernels one call launches, each once; the reading is
    the sum of their mean times. A window should record each of them
    ``reps`` times, but the profiler can lose records (seen on the card:
    9 of 10, 5 of 10, none): a short window is taken again, up to
    ``attempts`` windows, and then the fullest one is read by its means and
    reported in a ``profiler`` line. A window without every kernel raises:
    dividing what it recorded by ``reps`` would lie under the kernel's
    time."""
    from torch.profiler import ProfilerActivity, profile

    keys = dict(KERNEL_CLASSES)[CLASS_OF[kname]]
    fn()
    torch.cuda.synchronize()
    seen, best = [], {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        us = {}
        for evt in prof.events():
            if (evt.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in evt.name.lower() for k in keys)):
                us.setdefault(evt.name, []).append(evt.time_range.elapsed_us())
        seen.append(sum(map(len, us.values())))
        if len(us) == per_call and sum(map(len, us.values())) > sum(map(len, best.values())):
            best = us
        if seen[-1] == reps * per_call and len(us) == per_call:
            break
    if len(best) != per_call:
        raise AssertionError(f"torch.profiler recorded {seen} {kname} kernels in windows of "
                             f"{reps} calls, not every one of its {per_call} kernels")
    if seen[-1] != reps * per_call:
        emit({"phase": "profiler", "what": "windows that lost kernel records", "kernel": kname,
              "recorded_per_window": seen, "want": reps * per_call,
              "read_from": {n[:60]: len(v) for n, v in best.items()}})
    return sum(statistics.fmean(v) for v in best.values()) / 1e3


def bound(nbytes: float, flops: float, dtype, peak=PEAK_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak[dtype]
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
    return bound(nbytes, 2.0 * B * H * W * 9 * C * Cout, dtype, TC_FLOPS)


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
    """The flash kernel at ``shape``: [B, H, N, D], or [B, H, Nq, Nk, D] where
    the keys are not the queries (CoCa's pooler and cross-attention)."""
    B, Hh, N, *Nk, D = shape
    Nk = Nk[0] if Nk else N
    q = torch.randn(B, Hh, N, D, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(B, Hh, Nk, D, generator=gen, device="cuda").to(dtype) for _ in range(2))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    err = check_err(f"flash {shape} {dtype}", got, flash_attention_plain(q, k, v), dtype)
    s = torch.finfo(dtype).bits // 8
    bound_ms, bound_by = bound(2 * B * Hh * (N + Nk) * D * s, 4.0 * B * Hh * N * Nk * D, dtype,
                               TC_FLOPS)
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


# kernels one group_norm_silu call launches on each path of ``gn_plan``
GN_LAUNCHES = {"two_launch": 2, "cluster": 1}


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
    path = gn_plan(B, H * W, C, G, x.element_size())["path"]
    # library yardstick: torch's GroupNorm then SiLU on the NCHW view
    # (channels-last) of the same tensor
    xn, g, b = x.permute(0, 3, 1, 2), gamma.to(dtype), beta.to(dtype)

    def library():
        y = torch.nn.functional.group_norm(xn, G, g, b, 1e-5)
        return torch.nn.functional.silu(y) if silu else y

    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: group_norm_silu(x, gamma, beta, G, silu=silu)),
        device_ms=device_ms(lambda: group_norm_silu(x, gamma, beta, G, silu=silu), "gn",
                            per_call=GN_LAUNCHES[path]),
        path=path,
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


def flagship_engine(dtype, engine_opts=None, clip_type="CLIP", **kw) -> CLIPDriftEngine:
    eng = CLIPDriftEngine(FLAGSHIP, FLAGSHIP, score_map_ch_mult=(1, 1, 2, 4),
                          score_map_ngf=64, use_image_context=True, CLIP_Type=clip_type,
                          sde=DriftSDE(T=T, max_sigma=0.4), dtype=dtype,
                          engine_opts=engine_opts, device="cuda", **kw)
    for i, key in enumerate(("d_ema", "n_ema")):  # the nets test(use_ema=True) runs
        randomize_(eng.nets[key], seed=10 + i)
    randomize_(eng.text_encoder, seed=20)
    return eng


def ddpm_engine(dtype, clip_type="CLIP") -> CLIPDDPMEngine:
    eng = CLIPDDPMEngine(DDPM_NET, use_image_context=True, CLIP_Type=clip_type,
                         sde=DDPMSDE(T=T, max_sigma=DDPM_MAX_SIGMA), dtype=dtype,
                         device="cuda")
    randomize_(eng.nets["n_ema"], seed=30)
    randomize_(eng.text_encoder, seed=20)
    return eng


# ---------------------------------------------------------------- the golden

# tests/data_torch/tiny_bundle: the config, JAX's fp32 output on the bundle
# written from GOLDEN_SEED (io.ckpt), and the sha256 of each file of that
# bundle as JAX wrote it (sha256.json); tests/test_torch_bundle.py writes
# them with JAX and checks them against the committed files
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch",
                          "tiny_bundle")
GOLDEN_SEED, GOLDEN_ITER, GOLDEN_STEPS = 0, 100, 4  # the request: 4 of the config's T=8
GOLDEN_TREES = ("drift", "noise", "d_ema", "n_ema", "text")


def seeded_tree(tree, rng) -> dict:
    """A flax tree of the same paths and shapes as ``tree``, each leaf drawn
    from ``rng`` in sorted-key order: kernels ~ N(0, 1/fan_in), embeddings ~
    N(0, 1), norm scales ~ 1 + 0.1 N, everything else ~ 0.1 N (no leaf
    stays at its init: conv2, conv_out and the attention out projections
    start at zero)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = seeded_tree(v, rng)
            continue
        shape = tuple(v.shape)
        r = rng.standard_normal(shape)
        if k == "kernel":
            r = r / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            r = 1 + 0.1 * r
        elif k != "embedding":
            r = 0.1 * r
        out[k] = np.asarray(r, dtype=np.float32)
    return out


def golden_trees(templates: dict, seed: int = GOLDEN_SEED) -> dict:
    """The golden's weights: ``seeded_tree`` of each of ``GOLDEN_TREES``
    (the drift engine's four nets and its text tower, as flax trees), in
    that order from one generator."""
    rng = np.random.default_rng(seed)
    return {k: seeded_tree(templates[k], rng) for k in GOLDEN_TREES}


def sha256_files(models_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(models_dir)):
        with open(os.path.join(models_dir, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def load_golden() -> tuple:
    """(the golden's request, noise and JAX output as numpy arrays; its
    sha256.json)."""
    with open(os.path.join(GOLDEN_DIR, "sha256.json")) as f:
        shas = json.load(f)
    io = {k: np.array(v) for k, v in ckpt.load_pytree(os.path.join(GOLDEN_DIR, "io.ckpt")).items()}
    return io, shas


def write_golden_bundle(engine, models_dir) -> dict:
    """The golden bundle of a drift engine built from the golden's config,
    written with the port's codec (the engine's weights are not read, only
    its trees' paths and shapes); returns each file's sha256."""
    templates = {k: flax_params(engine.nets[k]) for k in GOLDEN_TREES[:4]}
    templates["text"] = flax_params(engine.text_encoder)
    trees = golden_trees(templates)
    ckpt.save_bundle(models_dir, GOLDEN_ITER, *(trees[k] for k in GOLDEN_TREES[:4]))
    ckpt.save_pytree(trees["text"], os.path.join(models_dir, TEXT_SIDECAR))
    return sha256_files(models_dir)


def write_speckle_med(root, n_per_name, res, emb_dim, names, seed=0) -> str:
    """A SpeckleMed-layout dataset of numpy phantoms (throwaway test data): per
    image a raw float32 clean disc-and-ramp phantom (B), the phantom under
    multiplicative gamma speckle and additive Gaussian noise (A), both in the
    modality's range (CT to 2400, cryo-EM to 300, else [0, 1]), and an
    embedding; ``dataset_file.json`` holds the records under train, test and
    val. Returns its path."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    scale = {"scatter artifact in CT": 2400.0, "noise in cryo-EM image": 300.0}
    yy, xx = np.mgrid[:res, :res] / res
    records = []
    for i in range(n_per_name * len(names)):
        name = names[i % len(names)]
        cx, cy, r = rng.uniform(0.3, 0.7, 2).tolist() + [rng.uniform(0.15, 0.3)]
        clean = (((xx - cx) ** 2 + (yy - cy) ** 2) < r * r) * 0.7 + 0.15 * xx
        noisy = clean * rng.gamma(4.0, 0.25, clean.shape) + 0.05 * rng.standard_normal(clean.shape)
        s = scale.get(name, 1.0)
        paths = {k: os.path.join(root, f"{k}_{i}.raw") for k in ("A", "B", "emb_A")}
        (noisy * s).astype(np.float32).tofile(paths["A"])
        (clean * s).astype(np.float32).tofile(paths["B"])
        rng.standard_normal(emb_dim).astype(np.float32).tofile(paths["emb_A"])
        records.append(dict(paths, name=name))
    index = os.path.join(root, "dataset_file.json")
    with open(index, "w") as f:
        json.dump({"train": records, "test": records, "val": records}, f)
    return index


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
    ("fused_conv", ("fgc_tc_kernel", "fgc_tf32x3_kernel")),
    ("flash", ("flash_tc_kernel", "flash_tf32x3_kernel")),
    ("gn_affine", ("gns_affine_kernel",)),
    # the sharded GroupNorm's two entries (the apply kernel on a per-(B,C)
    # scale and shift)
    ("gn_sums", ("gns_sums_kernel",)), ("gn_scale_shift", ("scaleshift",)),
    ("group_norm", ("gns_stats_kernel", "gns_apply_kernel", "gns_cluster_kernel")),
    ("library_conv", ("fprop", "conv", "dgrad", "wgrad")),
    ("gemm", ("gemm", "cutlass", "matmul")), ("reduce", ("reduce",)))
CLASS_OF = {"conv": "fused_conv", "flash": "flash", "gn": "group_norm", "affine": "gn_affine",
            "sums": "gn_sums", "apply": "gn_scale_shift"}


# the kernels each wrapper call launches, by name: one statistics or cluster
# launch per GroupNorm call (the apply launch rides on the statistics one)
LAUNCH_NAMES = {"conv": ("fgc_tc_kernel", "fgc_tf32x3_kernel"),
                "flash": ("flash_tc_kernel", "flash_tf32x3_kernel"),
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
    that start inside its range, widened to the middle of the gaps between
    replays), busy / range wall and the idle share, the top kernels; over
    the call, each kernel's launches by name (checked against
    ``SAMPLE_STEPS`` x ``PATHS``);
    per step of the request loop (the engine's ``sampler_step`` ranges:
    the noise draw and the replay) the host's launch calls, and the same
    for the call's inputs (``sampler_inputs``: the text encodings). The SM
    clock is sampled before and after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    batch = flagship_batch(gen)
    # a warm call: it captures the step anew where phase ``gaps``' set_sde
    # dropped main's graph, so the profiled call below only replays
    eng.test(batch, gen, sample_steps=SAMPLE_STEPS, eta=ETA)
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
    # the kernels each replay launched, held to the per-step counts over the
    # whole call (the replays are its only custom-kernel launches): exact
    # however the device's and the host's clocks sit against each other
    launched = Counter()
    for evt in kernels:
        for k, names in LAUNCH_NAMES.items():
            launched[k] += any(n in evt.name.lower() for n in names)
    if {k: launched[k] for k in PATHS[path]} != {k: n * SAMPLE_STEPS
                                                 for k, n in PATHS[path].items()}:
        raise AssertionError(f"{path}: kernels launched by name in {SAMPLE_STEPS} replayed "
                             f"steps {dict(launched)}, want {SAMPLE_STEPS} x {PATHS[path]}")
    # each replay's window on the device's timeline, widened to the middle of
    # the gaps between replays: the two clocks may sit tens of us apart
    pad = min([b[0] - a[1] for a, b in zip(windows, windows[1:])] or [0]) / 2
    steps = []
    for ws, we in windows:
        by_class, by_name, n_name = Counter(), Counter(), Counter()
        for evt in kernels:
            if not ws - pad <= evt.time_range.start <= we + pad:
                continue
            ms = evt.time_range.elapsed_us() / 1e3
            name = evt.name.lower()
            cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                       "elementwise_other")
            by_class[cls] += ms
            by_name[evt.name[:200]] += ms
            n_name[evt.name[:200]] += 1
        busy = sum(by_class.values())
        if busy <= 0:
            raise AssertionError(f"{path}: torch.profiler recorded no kernel in a replayed step")
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


def serve(path, eng, build_s, gpu, phase="main", name=None, res=RES, per_call=None,
          restorer=None) -> tuple:
    """Requests through ``Restorer.restore`` on the compiled sampler: 8
    images (the first call: warm-up and capture), 3 (padded to 8: the same
    graph), 8 again (steady state); then the first request's batch eagerly
    with the same generator seed, held against the graph's output. Each
    request's launches are counted from 0 (see the module docstring) and
    held to ``PATHS[path]`` per step plus ``per_call`` per sampler call
    (the image tower's, outside the graph). Lines are printed under
    ``phase`` and ``name`` (default ``path``), at ``res`` px; ``restorer``
    (default: one on ``eng``) serves them. Returns the launches of the
    graph-served requests."""
    name = name or path
    per_call = Counter(per_call or {})
    restorer = restorer or Restorer(eng, batch_size=BATCH, sample_steps=SAMPLE_STEPS, eta=ETA,
                                    seed=0, device="cuda")
    n_steps = len(strided_sampling_grid(T, SAMPLE_STEPS)[0])
    rng = np.random.default_rng(0)
    total = Counter()
    torch.cuda.reset_peak_memory_stats()
    first = None
    for n_img in (8, 3, 8):
        images = rng.uniform(-1, 1, (n_img, res, res, 1)).astype(np.float32)
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
        want = {k: n * (replayed + captured) + per_call[k] * calls for k, n in per_step.items()}
        if out.shape != images.shape or not np.isfinite(out).all():
            raise AssertionError(f"{name}, request of {n_img}: bad output {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        if (per_step != PATHS[path] or got != want or captured != (first is None)
                or replayed != n_steps * calls):
            raise AssertionError(f"{name}, request of {n_img}: launches {got} (want {want}), "
                                 f"per step at capture {per_step} (want {PATHS[path]}), "
                                 f"{captured} captures, {replayed} replays")
        total.update(got)
        # the launches outside the graph are the image tower's: counted
        # apart from the steps' (the kernels line's flash row gives them a
        # field of their own)
        outside = got["flash"] - per_step["flash"] * (replayed + captured)
        total["flash"] -= outside
        total["flash_tower"] += outside
        if first is None:
            first = (images, types, out)
        emit({"phase": phase, "path": name, "images": n_img, "batch": BATCH, "res": res,
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
    want = {k: n * n_steps + per_call[k] for k, n in PATHS[path].items()}
    if got != want:
        raise AssertionError(f"{name}, eager request: launches {got}, want {want}")
    emit({"phase": phase, "path": name, "what": "graph vs eager, the first request's batch, "
                                                "same generator seed",
          **check_graph_vs_eager(f"{name} request", graph_out, eager, torch.bfloat16),
          "graph_ms_per_step_steady": round(steady_ms, 3),
          "eager_ms_per_step": round(seconds / n_steps * 1e3, 3), "eager_launches": got,
          "gpu": gpu})
    return total


def serve_full_steps(eng, gpu, phase="main", name="drift") -> Counter:
    """Two 8-image requests at all T=100 steps (bench.py's flagship count):
    the first captures that step count's graph, the second is steady; their
    launches, checked as ``serve`` checks them; lines under ``phase`` and
    ``name``."""
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
        emit({"phase": phase, "path": name, "images": BATCH, "res": RES, "T": T,
              "sampler_steps": T, "eta": ETA, "dtype": "bfloat16", "compiled": True,
              "captured": bool(captured), "seconds": round(seconds, 4),
              "ms_per_step": round(seconds / T * 1e3, 3),
              "img_per_s": round(BATCH / seconds, 4), "launches": got, "gpu": gpu})
    return total


# phase gaps: the other max_sigma, and resize_like's cases (method names,
# [B, H, W, C] -> (h, w)) on the card
GAPS_SIGMA = 0.3
RESIZE_CASES = [((2, 64, 48, 3), (128, 36)), ((2, 63, 50, 3), (16, 70))]
RESIZE_TOL = 1e-5


def gaps_phase(eng, gpu) -> Counter:
    """Phase ``gaps`` (see the module docstring) on ``eng``, main's bf16
    drift engine. Returns the kernels' launches."""
    from instancediff_torch.ops.resize import METHODS, resize_like

    old = eng.sde
    rng = np.random.default_rng(5)
    batch = {"input": rng.uniform(-1, 1, (BATCH, RES, RES, 1)).astype(np.float32),
             "type_idx": np.arange(BATCH) % len(ARTIFACT_PROMPTS)}
    n_steps = len(strided_sampling_grid(T, SAMPLE_STEPS)[0])

    def request(compiled=True):
        return eng.test(batch, torch.Generator(device="cuda").manual_seed(6),
                        sample_steps=SAMPLE_STEPS, eta=ETA, compiled=compiled)

    zero_launches()
    captures = [eng.captures]
    before = request()
    eng.set_sde(DriftSDE(T=old.T, max_sigma=GAPS_SIGMA, eta=old.eta))
    captures.append(eng.captures)
    t0 = time.time()
    got = request()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    captures.append(eng.captures)
    visuals_equal = bool(np.array_equal(eng.get_visuals(), got.cpu().numpy()))
    eager = request(compiled=False)
    launches = read_launches()
    eng.set_sde(old)
    # main captured the first request's graph, unless its key differs: a
    # capturing request counts its warm-up step beside its replays, an
    # eager one every step
    warmups = captures[2] - captures[0]
    want = {k: n * (3 * n_steps + warmups) for k, n in PATHS["drift"].items()}
    moved = (got - before).abs().max().item()
    if (captures[2] != captures[1] + 1 or not visuals_equal or not moved > 0
            or launches != want):
        raise AssertionError(f"gaps: captures {captures}, get_visuals equal {visuals_equal}, "
                             f"moved {moved}, launches {launches} (want {want})")
    parity = check_graph_vs_eager("gaps request after set_sde", got, eager, torch.bfloat16)
    resize = {}
    for shape, (h, w) in RESIZE_CASES:
        x = torch.rand(shape, generator=torch.Generator().manual_seed(7)) * 2 - 1
        for name in METHODS:
            on_card = resize_like(x.cuda(), h, w, name).cpu()
            err = (on_card - resize_like(x, h, w, name)).abs().max().item()
            resize[name] = max(resize.get(name, 0.0), err)
    bad = {k: v for k, v in resize.items() if not v <= RESIZE_TOL}
    if bad:
        raise AssertionError(f"gaps: resize_like on the card vs the CPU beyond {RESIZE_TOL}: "
                             f"{bad}")
    emit({"phase": "gaps", "what": "set_sde on main's bf16 drift engine (max_sigma "
                                   f"{old.max_sigma} -> {GAPS_SIGMA}, T={old.T}), 8 images, "
                                   f"256 px, {n_steps} steps; resize_like on the card",
          "captures_before_after_set_sde_request": captures[1:], **parity,
          "max_abs_diff_from_old_sde": moved, "get_visuals_equals_output": visuals_equal,
          "seconds_capturing_request": round(seconds, 4), "launches": launches,
          "resize_cuda_vs_cpu_max_abs_err": resize, "resize_cases": RESIZE_CASES,
          "resize_tol": RESIZE_TOL, "gpu": gpu})
    return Counter(launches)


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


# the bundle phase: Configurations/flagship_test.yml (224 px, T=100), served
# in bf16 from a bundle written by engine.save; testUM over 2 images per
# artifact type in batches of 5
BUNDLE_CONFIG = "Configurations/flagship_test.yml"
BUNDLE_STEPS, TESTUM_PER_TYPE = 4, 2


def bundle_config(tmp, **test_opt) -> tuple:
    """A copy of ``BUNDLE_CONFIG`` in ``tmp``: bf16, the bundle in
    ``tmp/models``, results in ``tmp/results``, ``test`` updated with
    ``test_opt``, and its test set a SpeckleMed dataset of numpy phantoms
    written in ``tmp/data``. Returns (path, options)."""
    with open(BUNDLE_CONFIG) as f:
        opt = yaml.safe_load(f)
    opt["models"]["DriftNoise"]["dtype"] = "bfloat16"
    opt["test"].update(pth_dir=os.path.join(tmp, "models"),
                       result_dir=os.path.join(tmp, "results"), **test_opt)
    ds = opt["datasets"]["test"]
    ds["dataset_file"] = write_speckle_med(os.path.join(tmp, "data"), TESTUM_PER_TYPE,
                                           opt["resolution"], ds["emb_dim"],
                                           opt["artifact_type"])
    ds["max_dataset_size"] = TESTUM_PER_TYPE * len(opt["artifact_type"])
    path = os.path.join(tmp, os.path.basename(BUNDLE_CONFIG))
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path, opt


def serve_golden(gpu) -> None:
    """The golden (``GOLDEN_DIR``): its bundle rebuilt from the seed with the
    port's codec, checked file by file against the sha256 of the files JAX
    wrote, then served on the card through ``Restorer.from_config`` in fp32
    with cuDNN deterministic and the golden's noise, and held to JAX's output
    within ``TOL[fp32]``. Its launches are held to its own per-step counts
    here and kept out of the kernels line: its config is not a main path's."""
    io, shas = load_golden()
    cfg = os.path.join(GOLDEN_DIR, "config.yml")
    opt = load_options(cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_golden_") as models:
        # a CPU engine of the golden's config gives the trees' paths and shapes
        template = create_model(None, opt["models"]["DriftNoise"], phase="test", device="cpu")
        files = write_golden_bundle(template, models)
        if files != shas["files"]:
            raise AssertionError(f"golden bundle rebuilt by the port: sha256 {files}, JAX "
                                 f"wrote {shas['files']}")
        torch.backends.cudnn.deterministic = True
        try:
            r = Restorer.from_config(cfg, pth_dir=models, iteration=shas["iteration"],
                                     device="cuda")
            noise = torch.tensor(io["step_noise"], device="cuda")
            zero_launches()
            out = r.engine.test(io, sample_steps=GOLDEN_STEPS,
                                init_noise=torch.tensor(io["init_noise"], device="cuda"),
                                step_noise=list(noise))
            torch.cuda.synchronize()
            got = read_launches()
        finally:
            torch.backends.cudnn.deterministic = False
    want = torch.tensor(io["output"])
    out = out.float().cpu()
    err = (out - want).abs().max().item()
    limit = TOL[torch.float32] * max(1.0, want.abs().max().item())
    per_step = {k: r.engine.last_graph.launches[NAMES[k]] for k in WRAPPERS}
    expect = {k: n * (len(noise) + 1) for k, n in per_step.items()}
    if not (err <= limit and torch.isfinite(out).all()) or got != expect or not all(
            got[k] for k in ("conv", "flash", "affine")):
        raise AssertionError(f"golden on the card: max abs err {err} (limit {limit}), "
                             f"launches {got} (want {expect})")
    emit({"phase": "bundle", "what": "the golden (tests/data_torch/tiny_bundle), rebuilt by "
                                     "the port and served through from_config, fp32, against "
                                     "JAX's output", "files_match_jax_sha256": True,
          "max_abs_err_vs_jax": err, "tol": limit, "launches": got, "gpu": gpu})
    del r


def bundle_phase(gpu, tmp) -> tuple:
    """This slice's path at flagship width: a seeded engine of a bf16 copy of
    ``BUNDLE_CONFIG``, ``engine.save``d (bundle and text sidecar) into
    ``tmp``; ``Restorer.from_config`` on it; one 8-image request of
    ``BUNDLE_STEPS`` steps on the compiled sampler, bit-identical to the
    in-memory engine's on the same generator seed; the golden; then
    ``tools/testUM`` over the config's test set (2 phantoms per artifact
    type, batch 5). Launches are counted from 0 around each run and held to
    the per-step counts. Returns the launches of the flagship-width runs
    (the request and testUM), the config's path and options (the bundle
    and the phantoms stay in ``tmp`` for phase ``breadth``) and testUM's
    results."""
    total = Counter()
    cfg, opt = bundle_config(tmp)
    model_opt, sde_opt = opt["models"]["DriftNoise"], opt["sdes"]["driftSDE"]
    res, types = opt["resolution"], opt["artifact_type"]
    eng = create_model(None, model_opt, phase="test", sde=create_sde(sde_opt), device="cuda")
    for i, key in enumerate(("drift", "noise", "d_ema", "n_ema")):
        randomize_(eng.nets[key], seed=40 + i)
    randomize_(eng.text_encoder, seed=44)
    t0 = time.time()
    nbytes = eng.save(opt["test"]["pth_dir"], "latest")
    save_s = time.time() - t0
    files = sorted(os.listdir(opt["test"]["pth_dir"]))
    images = np.random.default_rng(4).uniform(-1, 1, (BATCH, res, res, 1)).astype(np.float32)
    names = [types[i % len(types)] for i in range(BATCH)]
    want = Restorer(eng, batch_size=BATCH, sample_steps=BUNDLE_STEPS, seed=0,
                    device="cuda").restore(images, names)
    del eng
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.time()
    r = Restorer.from_config(cfg, batch_size=BATCH, sample_steps=BUNDLE_STEPS, seed=0,
                             device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    n_steps = len(strided_sampling_grid(sde_opt["T"], BUNDLE_STEPS)[0])
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = r.restore(images, names)
    first_s = time.time() - t0
    got = read_launches()
    per_step = {k: r.engine.last_graph.launches[NAMES[k]] for k in PATHS["drift"]}
    if per_step != PATHS["drift"] or got != {k: n * (n_steps + 1)  # its warm-up step
                                             for k, n in PATHS["drift"].items()}:
        raise AssertionError(f"bundle request: launches {got}, per step at capture "
                             f"{per_step} (want {PATHS['drift']} x {n_steps + 1})")
    total.update(got)
    if not np.array_equal(out, want):
        raise AssertionError("the request served from the bundle differs from the "
                             "in-memory engine's: max abs diff "
                             f"{float(np.abs(out - want).max())}")
    emit({"phase": "bundle", "what": f"{os.path.basename(BUNDLE_CONFIG)} (bf16) saved by "
                                     "engine.save and served by Restorer.from_config",
          "files": files, "bundle_bytes": nbytes, "save_s": round(save_s, 3),
          "from_config_s": round(load_s, 3), "text_weights": r.engine.text_weights,
          "first_request": {"images": BATCH, "res": res, "sampler_steps": n_steps,
                            "seconds": round(first_s, 4),
                            "img_per_s": round(BATCH / first_s, 4), "captured": True},
          "bit_identical_to_in_memory_engine": True, "launches": got, "gpu": gpu})
    del r
    torch.cuda.empty_cache()

    serve_golden(gpu)

    batch_s = []  # each batch's sampler seconds, the device drained
    real_test = CLIPDriftEngine.test

    def timed_test(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.time()
        out = real_test(self, *args, **kwargs)
        torch.cuda.synchronize()
        batch_s.append(time.time() - t)
        return out

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with mock.patch.object(CLIPDriftEngine, "test", timed_test):
        results = testUM.main(["-opt", cfg, "--sample-steps", str(BUNDLE_STEPS)])
    wall_s = time.time() - t0
    got = read_launches()
    n_img = sum(v["num"] for v in results.values())
    batches = -(-n_img // opt["test"]["batch_size"])
    if got != {k: n * (n_steps * batches + 1) for k, n in PATHS["drift"].items()}:
        raise AssertionError(f"testUM: launches {got} over {batches} batches")
    total.update(got)
    means = {name: {k: float(np.mean(v[k])) for k in ("RMSE", "SSIM", "PSNR")}
             for name, v in results.items() if v["num"]}
    if sorted(means) != sorted(types) or not all(
            np.isfinite(list(m.values())).all() for m in means.values()):
        raise AssertionError(f"testUM: bad results {means}")
    if len(batch_s) != batches:
        raise AssertionError(f"testUM: {len(batch_s)} sampler calls, {batches} batches")
    emit({"phase": "bundle", "what": "testUM on the bundle: SpeckleMed phantoms, 2 per "
                                     f"artifact type, batch {opt['test']['batch_size']}, "
                                     f"{res} px, {n_steps} steps, bf16; a smoke reading, "
                                     "not a throughput: the first batch captures the step",
          "images": n_img, "per_type_mean": means, "seconds_with_setup": round(wall_s, 3),
          "batch_sampler_s": [round(t, 4) for t in batch_s],
          "replayed_batch_img_per_s": [round(opt["test"]["batch_size"] / t, 4)
                                       for t in batch_s[1:]],
          "launches": got, "gpu": gpu})
    return total, cfg, opt, means


# the served fp32 request: flagship_test.yml at its own dtype (no
# models.DriftNoise.dtype: fp32), 224 px, batch 5, 4 steps
FP32_BATCH = 5


def fp32_request(gpu) -> Counter:
    """``BUNDLE_CONFIG`` at its own dtype, fp32, as ``testUM`` and
    ``Restorer.from_config`` serve it: a seeded fp32 engine saved in a
    temporary directory and served by ``from_config``, one request of
    ``FP32_BATCH`` images at 224 px of ``BUNDLE_STEPS`` steps on the compiled
    sampler (captures), then the same again (replays; its ms per step is the
    reading). Launches are held to the per-step counts. Returns them."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fp32_") as tmp:
        cfg, opt = bundle_config(tmp)
        opt["models"]["DriftNoise"].pop("dtype")
        with open(cfg, "w") as f:
            yaml.safe_dump(opt, f)
        model_opt, sde_opt = opt["models"]["DriftNoise"], opt["sdes"]["driftSDE"]
        res, types = opt["resolution"], opt["artifact_type"]
        eng = create_model(None, model_opt, phase="test", sde=create_sde(sde_opt), device="cuda")
        for i, key in enumerate(("drift", "noise", "d_ema", "n_ema")):
            randomize_(eng.nets[key], seed=50 + i)
        randomize_(eng.text_encoder, seed=54)
        eng.save(opt["test"]["pth_dir"], "latest")
        del eng
        torch.cuda.empty_cache()
        r = Restorer.from_config(cfg, batch_size=FP32_BATCH, sample_steps=BUNDLE_STEPS, seed=0,
                                 device="cuda")
        if r.engine.dtype != torch.float32:
            raise AssertionError(f"{BUNDLE_CONFIG} served in {r.engine.dtype}, not float32")
        n_steps = len(strided_sampling_grid(sde_opt["T"], BUNDLE_STEPS)[0])
        images = np.random.default_rng(5).uniform(-1, 1, (FP32_BATCH, res, res, 1)).astype(
            np.float32)
        names = [types[i % len(types)] for i in range(FP32_BATCH)]
        total, seconds = Counter(), []
        for capture in (True, False):
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            out = r.restore(images, names)
            torch.cuda.synchronize()
            seconds.append(time.time() - t0)
            got = read_launches()
            want = {k: n * (n_steps + capture) for k, n in PATHS["drift"].items()}
            per_step = {k: r.engine.last_graph.launches[NAMES[k]] for k in PATHS["drift"]}
            if per_step != PATHS["drift"] or got != want:
                raise AssertionError(f"fp32 request: launches {got}, per step at capture "
                                     f"{per_step} (want {want})")
            if out.shape != images.shape or not np.isfinite(out).all():
                raise AssertionError(f"fp32 request: output {out.shape}, finite "
                                     f"{bool(np.isfinite(out).all())}")
            total.update(got)
        emit({"phase": "bundle", "what": f"{os.path.basename(BUNDLE_CONFIG)} at its own dtype "
                                         "(fp32) saved and served by Restorer.from_config: "
                                         "the split-TF32 fused conv and flash kernels",
              "images": FP32_BATCH, "res": res, "sampler_steps": n_steps,
              "capture_request_s": round(seconds[0], 4), "replay_request_s": round(seconds[1], 4),
              "ms_per_step": round(seconds[1] / n_steps * 1e3, 3),
              "img_per_s": round(FP32_BATCH / seconds[1], 4),
              "launches_per_step": PATHS["drift"], "launches": dict(total), "gpu": gpu})
        del r
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- breadth

# the SMM-less UNet: this config's net with text_module none
SMM_LESS_CONFIG = "Configurations/flagship_tpu.yml"
# bf16 at full width, relative to the largest output, as FORWARD_TOL holds
# fp32: a UNet forward through the kernels against the plain versions, and
# testUM's restored images on the unfused body against the fused run (4
# sampler steps of two nets). Each kernel lies within one bf16 ulp (2^-8)
# of its plain version, and the bodies round at different points (the
# fused one normalises in fp32 and rounds once per conv; the unfused one
# rounds the normalised input, the conv's output and each add); the
# differences compound over 22 ResBlocks: read 1.0e-2 and 1.2e-2 (forwards)
# and 8.7e-3 (testUM) on the card
BF16_FORWARD_TOL = 2e-2
# the on-device metrics (float32) against eval_restoration (float64): PSNR
# in dB, SSIM
METRIC_TOL = {"PSNR": 1e-3, "SSIM": 1e-4}
# the kernels a drift request runs, by the names the trace records
TRACE_KERNELS = {"conv": "fgc_tc_kernel", "flash": "flash_tc_kernel",
                 "affine": "gns_affine_kernel"}
TRACE_ANNOTATION = "chip_smoke.request"


def triptychs(result_dir, res) -> dict:
    """testUM's ``LQ|pred|GT`` files under ``result_dir``: {path relative to
    it: (pred, GT)}, each [res, res] float32."""
    out = {}
    for name in sorted(os.listdir(result_dir)):
        for f in sorted(os.listdir(os.path.join(result_dir, name))):
            trip = np.fromfile(os.path.join(result_dir, name, f), np.float32).reshape(res, 3 * res)
            out[os.path.join(name, f)] = (trip[:, res:2 * res], trip[:, 2 * res:])
    return out


def knob_testum(gpu, cfg, opt, fused_means) -> Counter:
    """(a) ``testUM --knob fused_gnconv=0`` on phase ``bundle``'s bundle and
    phantoms: an unknown knob raises before any batch; the engine serves the
    unfused body (per-step launches at capture ``PATHS["drift_unfused"]``),
    its restored images held to the fused run's within ``BF16_FORWARD_TOL``; then
    (d) ``metrics.psnr_tensor``/``ssim_tensor`` on its outputs on the card
    against the host's ``eval_restoration``. Returns its launches."""
    res, batch = opt["resolution"], opt["test"]["batch_size"]
    result_dir = opt["test"]["result_dir"]
    os.replace(result_dir, result_dir + "_fused")
    engines, calls = [], []
    real_build, real_test = testUM.engine_from_config, CLIPDriftEngine.test

    def build(*args, **kwargs):
        engines.append(real_build(*args, **kwargs))
        return engines[-1]

    def counted_test(self, *args, **kwargs):
        calls.append(1)
        return real_test(self, *args, **kwargs)

    argv = ["-opt", cfg, "--sample-steps", str(BUNDLE_STEPS)]
    with mock.patch.object(testUM, "engine_from_config", build), \
            mock.patch.object(CLIPDriftEngine, "test", counted_test):
        zero_launches()
        try:
            testUM.main(argv + ["--knob", "no_such_knob=1"])
            raise AssertionError("testUM --knob no_such_knob=1 did not raise")
        except KeyError as e:
            refused = str(e)
        if engines or calls or any(read_launches().values()):
            raise AssertionError("testUM --knob no_such_knob=1 ran a batch before raising")
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        results = testUM.main(argv + ["--knob", "fused_gnconv=0"])
        wall_s = time.time() - t0
    got = read_launches()
    eng = engines[0]
    per_step = {k: eng.last_graph.launches[NAMES[k]] for k in WRAPPERS}
    n_steps = len(strided_sampling_grid(opt["sdes"]["driftSDE"]["T"], BUNDLE_STEPS)[0])
    n_img = sum(v["num"] for v in results.values())
    batches = -(-n_img // batch)
    want = {k: n * (n_steps * batches + 1) for k, n in PATHS["drift_unfused"].items()}
    if (eng.engine_opts != {"fused_gnconv": 0} or per_step != PATHS["drift_unfused"]
            or any(net.use_fused_gnconv for net in eng.nets.values()) or got != want
            or len(calls) != batches):
        raise AssertionError(f"testUM --knob fused_gnconv=0: engine_opts {eng.engine_opts}, "
                             f"per step at capture {per_step}, launches {got} (want {want}), "
                             f"{len(calls)} batches")
    means = {name: {k: float(np.mean(v[k])) for k in ("RMSE", "SSIM", "PSNR")}
             for name, v in results.items() if v["num"]}
    fused, knob = triptychs(result_dir + "_fused", res), triptychs(result_dir, res)
    if sorted(fused) != sorted(knob) or len(knob) != n_img:
        raise AssertionError(f"testUM --knob: outputs {sorted(knob)}, fused {sorted(fused)}")
    err = max(float(np.abs(knob[f][0] - fused[f][0]).max()) for f in fused)
    largest = max(float(np.abs(fused[f][0]).max()) for f in fused)
    limit = BF16_FORWARD_TOL * max(1.0, largest)
    emit({"phase": "breadth", "what": "(a) testUM --knob fused_gnconv=0 on the bundle's "
                                      "phantoms against the fused run, bf16",
          "unknown_knob_raised": refused, "engine_opts": eng.engine_opts,
          "per_step_at_capture": per_step, "launches": got, "images": n_img,
          "seconds_with_setup": round(wall_s, 3), "per_type_mean": means,
          "fused_per_type_mean": fused_means, "max_abs_err_vs_fused": err,
          "fused_max_abs": largest, "tol": limit, "tol_rel": BF16_FORWARD_TOL, "gpu": gpu})
    if not err <= limit:
        raise AssertionError(f"testUM --knob fused_gnconv=0: restored images {err} from the "
                             f"fused run's (limit {limit})")

    # (d) the on-device metrics on these outputs, against the host's
    files = sorted(knob)
    pred = torch.tensor(np.stack([knob[f][0] for f in files]), device="cuda") / 2 + 0.5
    gt = torch.tensor(np.stack([knob[f][1] for f in files]), device="cuda") / 2 + 0.5
    device = {"PSNR": metrics.psnr_tensor(pred, gt).cpu().numpy(),
              "SSIM": metrics.ssim_tensor(pred, gt).cpu().numpy()}
    host = [eval_restoration(*knob[f]) for f in files]
    errs = {k: float(np.abs(device[k] - [h[k] for h in host]).max()) for k in METRIC_TOL}
    emit({"phase": "breadth", "what": "(d) psnr_tensor / ssim_tensor on the card against the "
                                      "host's eval_restoration, (a)'s outputs",
          "images": len(files), "max_abs_err": errs, "tol": METRIC_TOL,
          "device_psnr": [round(float(v), 4) for v in device["PSNR"]],
          "device_ssim": [round(float(v), 5) for v in device["SSIM"]], "gpu": gpu})
    if not all(errs[k] <= METRIC_TOL[k] for k in METRIC_TOL):
        raise AssertionError(f"on-device metrics against the host's: {errs} (tol {METRIC_TOL})")
    return Counter(got)


def smm_less_forwards(gpu) -> None:
    """(b) The UNet without SMM text conditioning, built by ``create_net`` from
    ``SMM_LESS_CONFIG``'s ``nnet_settings`` with ``text_module: none`` (and
    the model block's ``use_image_context``, as the engine passes it),
    seeded random weights: one forward at bf16, batch 8, 256 px, and one at
    fp32, batch 2, on the fused body and on the unfused body, each through
    the kernels and through their plain versions (bf16 within
    ``BF16_FORWARD_TOL``, fp32 within ``FORWARD_TOL``), with the launches per
    forward by kernel and the new conv launch shapes (in ``CONV_SHAPES``)."""
    model_opt = load_options(SMM_LESS_CONFIG)["models"]["DriftNoise"]
    settings = dict(model_opt["nnet_settings"], text_module="none",
                    use_image_context=bool(model_opt.get("use_image_context")))
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype, batch, tol in ((torch.bfloat16, BATCH, BF16_FORWARD_TOL),
                              (torch.float32, 2, FORWARD_TOL)):
        net = create_net(settings, dtype=dtype, device="cuda")
        randomize_(net, seed=60)
        args = unet_args(batch, gen)
        for body, path in (("fused", "drift"), ("unfused", "drift_unfused")):
            net.use_fused_gnconv = body == "fused"
            shapes = record_launch_shapes(net, args)
            with torch.inference_mode():
                zero_launches()
                got = net(*args)
                torch.cuda.synchronize()
                launches = read_launches()
                with contextlib.ExitStack() as stack:
                    for patch in plain_kernels():
                        stack.enter_context(patch)
                    want = net(*args)
            err = (got.float() - want.float()).abs().max().item()
            limit = tol * max(1.0, want.float().abs().max().item())
            per_forward = {k: n // 2 for k, n in PATHS[path].items()}
            conv_shapes = sorted({s for s, _ in shapes["conv"]})
            emit({"phase": "breadth", "what": f"(b) SMM-less UNet (text_module none) from "
                                              f"create_net, {body} body, kernels vs plain",
                  "dtype": str(dtype), "batch": batch, "res": RES,
                  "pred_shape": list(got.shape), "max_abs_err": err, "tol": limit,
                  "launches_per_forward": launches, "conv_shapes": conv_shapes, "gpu": gpu})
            if not (err <= limit and torch.isfinite(got).all()) or launches != per_forward:
                raise AssertionError(f"SMM-less UNet, {body} body, {dtype}: err {err} (limit "
                                     f"{limit}), launches {launches} (want {per_forward})")
            # the first decoder conv of each level reads [h, skip] alone: C =
            # 2 Cout, a width no drift forward launches (there C = 2 Cout + 16)
            concat = [s for s in conv_shapes if s[3] == 2 * s[4]]
            if (dtype, body) == (torch.bfloat16, "fused") and (not concat or any(
                    s not in CONV_SHAPES for s in concat)):
                raise AssertionError(f"SMM-less decoder conv shapes {concat} are not all "
                                     "held in check (CONV_SHAPES)")
        del net
        torch.cuda.empty_cache()


def traced_requests(gpu, cfg) -> Counter:
    """(c) ``utils.tracing`` on phase ``bundle``'s bundle served by
    ``Restorer.from_config`` (bf16, batch 8, ``BUNDLE_STEPS`` steps): three
    requests timed by a ``StepTimer`` (the first, which captures the step,
    its warm-up), then one replayed request inside ``tracing.trace``, each
    request under ``annotate``. The exported trace must hold the annotation
    and each kernel, by name, steps x its per-step count; the device's
    memory statistics. Returns the requests' launches."""
    r = Restorer.from_config(cfg, batch_size=BATCH, sample_steps=BUNDLE_STEPS, seed=0,
                             device="cuda")
    opt = load_options(cfg)
    res, types = opt["resolution"], opt["artifact_type"]
    n_steps = len(strided_sampling_grid(opt["sdes"]["driftSDE"]["T"], BUNDLE_STEPS)[0])
    images = np.random.default_rng(8).uniform(-1, 1, (BATCH, res, res, 1)).astype(np.float32)
    names = [types[i % len(types)] for i in range(BATCH)]
    timer = tracing.StepTimer(warmup=1)
    total = Counter()
    for _ in range(3):
        zero_launches()
        with timer, tracing.annotate(TRACE_ANNOTATION):
            r.restore(images, names)
            torch.cuda.synchronize()
        total.update(read_launches())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
        zero_launches()
        with tracing.trace(log_dir), tracing.annotate(TRACE_ANNOTATION):
            out = r.restore(images, names)
        got = read_launches()
        path = os.path.join(log_dir, tracing.TRACE_FILE)
        nbytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    total.update(got)
    want = {k: n * n_steps for k, n in PATHS["drift"].items()}
    traced = {k: sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))
              for k, name in TRACE_KERNELS.items()}
    annotations = Counter(e.get("cat") for e in events if e.get("name") == TRACE_ANNOTATION)
    emit({"phase": "breadth", "what": "(c) utils.tracing: one replayed drift request "
                                      "(flagship_test.yml bundle, bf16, batch 8) inside "
                                      "trace(), under annotate()",
          "launches": got, "trace_kernels": traced,
          "want": {k: want[k] for k in TRACE_KERNELS}, "annotation_events": dict(annotations),
          "trace_bytes": nbytes, "trace_events": len(events),
          "step_timer": timer.summary(), "step_timer_message": timer.message(),
          "device_memory_stats": tracing.device_memory_stats(), "gpu": gpu})
    if (traced != {k: want[k] for k in TRACE_KERNELS} or got != want or not annotations
            or not np.isfinite(out).all()):
        raise AssertionError(f"trace: kernels by name {traced} (want {want}), launches {got}, "
                             f"annotation events {dict(annotations)}")
    del r
    torch.cuda.empty_cache()
    return total


def breadth_phase(gpu, cfg, opt, fused_means) -> Counter:
    """Phase ``breadth``: (a) and (d) ``knob_testum``, (b)
    ``smm_less_forwards``, (c) ``traced_requests``, on phase ``bundle``'s
    bundle and phantoms. Returns the launches of (a) and (c)."""
    total = knob_testum(gpu, cfg, opt, fused_means)
    smm_less_forwards(gpu)
    total.update(traced_requests(gpu, cfg))
    return total


# ---------------------------------------------------------------- encoders

# the image tower's attention on the flash kernel: [B, heads, tokens, 64] at
# 224 px (197 tokens) and 256 px (257), fp32 (the tower's dtype) and bf16
TOWER_FLASH_SHAPES = [((BATCH, 12, 197, 64), torch.float32), ((BATCH, 12, 257, 64), torch.float32),
                      ((BATCH, 12, 197, 64), torch.bfloat16)]
TOWER_LAYERS = 12  # ViT-B/16: one flash launch per block per call
# the image context is L2-normalised: each norm within this of 1
NORM_TOL = 1e-5
# precompute_embeddings: each written embedding against the tower run directly
EMB_TOL = 1e-5
PRECOMPUTE_PER_TYPE = 2


def device_busy(fn, reps: int = 3) -> dict:
    """``fn`` alone on the device under torch.profiler, ``reps`` times after
    a warm-up: per call the host wall (synchronised), the device time of
    its kernels, the kernels launched and the host's launch calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    host = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
               and any(e.name.startswith(h) for h in HOST_LAUNCHES[:2]))
    return {"wall_ms": round(wall, 3), "device_busy_ms": round(busy, 3),
            "idle_share": round(1 - busy / wall, 4), "kernels": len(kernels) // reps,
            "host_kernel_launches": host // reps}


def vit_state_dict(rng, width=768, layers=12, embed=512, grid=14, patch=16) -> dict:
    """A seeded random ViT-B/16 state dict in open_clip's timm layout
    (``visual.trunk.*``, fused ``qkv``, ``visual.head.proj``): weights ~
    N(0, 1/fan_in), norm scales ~ 1 + 0.1 N, biases ~ 0.1 N, the class
    token and position table ~ 0.02 N."""
    def w(*shape):
        fan_in = int(np.prod(shape[1:]))
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

    def n(*shape, scale=0.1, mean=0.0):
        return torch.from_numpy((mean + scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {"visual.trunk.patch_embed.proj.weight": w(width, 3, patch, patch),
          "visual.trunk.patch_embed.proj.bias": n(width),
          "visual.trunk.cls_token": n(1, 1, width, scale=0.02),
          "visual.trunk.pos_embed": n(1, grid * grid + 1, width, scale=0.02),
          "visual.trunk.norm.weight": n(width, mean=1.0), "visual.trunk.norm.bias": n(width),
          "visual.head.proj.weight": w(embed, width)}
    for i in range(layers):
        b = f"visual.trunk.blocks.{i}."
        sd.update({b + "norm1.weight": n(width, mean=1.0), b + "norm1.bias": n(width),
                   b + "norm2.weight": n(width, mean=1.0), b + "norm2.bias": n(width),
                   b + "attn.qkv.weight": w(3 * width, width), b + "attn.qkv.bias": n(3 * width),
                   b + "attn.proj.weight": w(width, width), b + "attn.proj.bias": n(width),
                   b + "mlp.fc1.weight": w(4 * width, width), b + "mlp.fc1.bias": n(4 * width),
                   b + "mlp.fc2.weight": w(width, 4 * width), b + "mlp.fc2.bias": n(width)})
    return sd


def serve_with_tower(gpu) -> Counter:
    """The on-device ``emb_A`` path: a seeded ``flagship_test.yml`` engine
    (224 px, bf16) saved with its text sidecar, a seeded ViT-B/16 (width 768,
    12 layers, 12 heads, fp32) written as ``image_params.ckpt`` with the
    port's codec, both served by ``Restorer.from_config`` with
    ``test.on_device_emb``; requests of 8, 3 (padded) and 8 at 4 steps
    through the graph and one eager (``serve``: the tower's 12 flash
    launches per call beside the steps', returned as ``flash_tower``); the
    image context's norms; the
    tower against itself on the plain attention (fp32); its ms per call
    and device busy; a request with the tower and one with ``A_emb``
    given. Returns the graph-served requests' launches."""
    from instancediff_torch.models.clip_vit import build_image_tower, image_context
    from instancediff_torch.serving import IMAGE_SIDECAR

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tower_") as tmp:
        cfg, opt = bundle_config(tmp, on_device_emb=True)
        models = opt["test"]["pth_dir"]
        res = opt["resolution"]
        eng = create_model(None, opt["models"]["DriftNoise"], phase="test",
                           sde=create_sde(opt["sdes"]["driftSDE"]), device="cuda")
        for i, key in enumerate(("drift", "noise", "d_ema", "n_ema")):
            randomize_(eng.nets[key], seed=60 + i)
        randomize_(eng.text_encoder, seed=64)
        eng.save(models, "latest")
        del eng
        tower = build_image_tower(embed_dim=512, image_size=res)
        randomize_(tower, seed=65)
        ckpt.save_pytree(flax_params(tower), os.path.join(models, IMAGE_SIDECAR))
        torch.cuda.empty_cache()
        t0 = time.time()
        r = Restorer.from_config(cfg, batch_size=BATCH, sample_steps=SAMPLE_STEPS, eta=ETA,
                                 seed=0, device="cuda")
        torch.cuda.synchronize()
        load_s = time.time() - t0
        eng = r.engine
        if eng.image_tower is None or sum(p.numel() for p in eng.image_tower.parameters()) \
                != sum(p.numel() for p in tower.parameters()):
            raise AssertionError("from_config attached no ViT-B/16 tower")
        total = serve("drift", eng, load_s, gpu, phase="encoders", name="drift_on_device_emb",
                      res=res, per_call={"flash": TOWER_LAYERS}, restorer=r)

        mu = torch.rand(BATCH, res, res, 1, generator=torch.Generator(device="cuda")
                        .manual_seed(8), device="cuda") * 2 - 1
        with torch.inference_mode():
            emb = image_context(eng.image_tower, mu)
            norms = torch.linalg.vector_norm(emb.float(), dim=-1).flatten()
            with tower_flash_shapes(plain=True):
                plain = image_context(eng.image_tower, mu)
            raw = eng.image_tower(mu)
            with tower_flash_shapes(plain=True):
                raw_plain = eng.image_tower(mu)
            tower_ms = cuda_ms(lambda: image_context(eng.image_tower, mu))
            busy = device_busy(lambda: image_context(eng.image_tower, mu))
        if emb.shape != (BATCH, 1, 512) or not torch.isfinite(emb).all() or \
                (norms - 1).abs().max().item() > NORM_TOL:
            raise AssertionError(f"image context: shape {tuple(emb.shape)}, norms {norms}")
        err = (raw - raw_plain).abs().max().item()
        limit = FORWARD_TOL * max(1.0, raw_plain.abs().max().item())
        if not err <= limit:
            raise AssertionError(f"tower, flash kernel vs plain attention: {err} > {limit}")
        # a request with the tower, then one with A_emb given (the tower
        # detached: the same graph, its image context from the request)
        images = np.random.default_rng(9).uniform(-1, 1, (BATCH, res, res, 1)).astype(np.float32)
        emb_given = np.random.default_rng(10).standard_normal((BATCH, 1, 512)).astype(np.float32)
        timed = {}
        for what in ("with_tower", "A_emb_given", "with_tower_again"):
            if what == "A_emb_given":
                attached, eng.image_tower = eng.image_tower, None
            torch.cuda.synchronize()
            t0 = time.time()
            r.restore(images, "speckle in OCT", emb=emb_given)
            torch.cuda.synchronize()
            timed[what] = round((time.time() - t0) * 1e3, 3)
            if what == "A_emb_given":
                eng.image_tower = attached
        emit({"phase": "encoders", "what": "the on-device image context: from_config with "
                                           "test.on_device_emb (flagship_test.yml, 224 px, bf16; "
                                           "the ViT-B/16 tower fp32)",
              "from_config_s": round(load_s, 3), "tower_params": sum(
                  p.numel() for p in eng.image_tower.parameters()),
              "emb_norm_min_max": [norms.min().item(), norms.max().item()], "norm_tol": NORM_TOL,
              "tower_kernel_vs_plain_max_abs_err": err, "tol": limit,
              "normalised_kernel_vs_plain_max_abs_err": (emb - plain).abs().max().item(),
              "tower_ms_per_call": round(tower_ms, 3), "tower_profile": busy,
              "request_ms_8_images_4_steps": timed, "gpu": gpu})
        del r, eng, tower
        torch.cuda.empty_cache()
    return total


def encoded_text_profile(eng) -> dict:
    """The per-call text encodings of a sampler call (``_inputs``: every
    SMM context of both nets, and the prompts), timed and profiled."""
    batch = {"input": torch.zeros(BATCH, RES, RES, 1, device="cuda"),
             "type_idx": torch.arange(BATCH, device="cuda") % len(ARTIFACT_PROMPTS)}
    with torch.inference_mode():
        return device_busy(lambda: eng._inputs(batch, True))


def biomedclip_paths(gpu) -> Counter:
    """``CLIP_Type: BiomedCLIP`` at the flagship's widths (nf 64, ch_mult
    [1,2,4,4], 768-wide SMM contexts; the 12-layer PubMedBERT tower, context
    256), 256 px, batch 8, bf16: the drift engine's requests of 8, 3 and 8
    at 4 steps through the graph and one eager, two T=100 requests, the
    per-call text encodings profiled; the DDPM engine's requests; one drift
    train step on the plain path. Returns the graph-served launches."""
    total = Counter()
    t0 = time.time()
    eng = flagship_engine(torch.bfloat16, clip_type="BiomedCLIP")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    if eng.token_embed_dim != 768 or eng.prompt_mask is None:
        raise AssertionError("the BiomedCLIP engine's contexts are not 768 wide")
    total.update(serve("drift", eng, build_s, gpu, phase="encoders", name="drift_biomedclip"))
    total.update(serve_full_steps(eng, gpu, phase="encoders", name="drift_biomedclip"))
    emit({"phase": "encoders", "what": "BiomedCLIP drift: the per-call text encodings (4 SMM "
                                       "contexts x 2 nets x 5 prompts through the 12-layer "
                                       "BERT tower), alone on the device",
          "prompt_tokens": int(eng.prompt_mask.sum(dim=1).max()),
          "text_encodings": encoded_text_profile(eng), "gpu": gpu})
    del eng
    torch.cuda.empty_cache()
    eng = ddpm_engine(torch.bfloat16, clip_type="BiomedCLIP")
    total.update(serve("ddpm", eng, 0.0, gpu, phase="encoders", name="ddpm_biomedclip"))
    del eng
    torch.cuda.empty_cache()

    eng = flagship_engine(torch.bfloat16, clip_type="BiomedCLIP", if_train=True, image_size=RES)
    rng = np.random.default_rng(11)
    batch = {"input": rng.uniform(-1, 1, (2, RES, RES, 1)).astype(np.float32),
             "target": rng.uniform(-1, 1, (2, RES, RES, 1)).astype(np.float32),
             "type_idx": np.array([0, 3]), "A_emb": np.zeros((2, 1, 512), np.float32)}
    contexts = [c.detach().clone() for c in eng.nets["drift"].smm_contexts()]
    before = sum(read_launches().values())
    torch.cuda.synchronize()
    t0 = time.time()
    loss = eng.optimize_parameters(batch, torch.Generator(device="cuda").manual_seed(12))
    torch.cuda.synchronize()
    moved = all(not torch.equal(a, b) for a, b in zip(contexts, eng.nets["drift"].smm_contexts()))
    if not np.isfinite(loss) or not moved or sum(read_launches().values()) != before:
        raise AssertionError(f"BiomedCLIP drift train step: loss {loss}, contexts moved {moved}")
    emit({"phase": "encoders", "what": f"one BiomedCLIP drift train step on the plain path, "
                                       f"{RES} px, batch 2, bf16 compute, fp32 master weights",
          "loss": loss, "smm_contexts_moved": moved, "seconds_with_first_call": round(
              time.time() - t0, 3), "gpu": gpu})
    del eng
    torch.cuda.empty_cache()
    return total


def precompute_phase(gpu) -> Counter:
    """``tools/precompute_embeddings`` on the card: a seeded ViT-B/16 state
    dict in open_clip's layout and 10 SpeckleMed phantoms at 224 px; each
    written ``_emb.raw`` against the tower run directly (within
    ``EMB_TOL``), and the index naming every file. Returns the tool's
    launches (the tower's flash launches as ``flash_tower``)."""
    from instancediff_torch.data.med_dataset import normalize_pair
    from instancediff_torch.models.biomedclip import get_BiomedCLIP
    from instancediff_torch.tools import precompute_embeddings

    with tempfile.TemporaryDirectory(prefix="chip_smoke_emb_") as tmp:
        index = write_speckle_med(os.path.join(tmp, "data"), PRECOMPUTE_PER_TYPE, 224, 512,
                                  ARTIFACT_PROMPTS)
        path = os.path.join(tmp, "open_clip_vit_b16.bin")
        torch.save(vit_state_dict(np.random.default_rng(13)), path)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            n = precompute_embeddings.main(["--index", index, "--checkpoint", path])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = Counter(read_launches())
        with open(index) as f:
            records = [rec for recs in json.load(f).values() for rec in recs]
        model = get_BiomedCLIP(checkpoint_path=path, device="cuda")
        images = np.stack([normalize_pair(np.fromfile(rec["A"], np.float32).reshape(224, 224, 1),
                                          np.zeros(1), rec["name"])[0] for rec in records])
        want = model.encode_image(images).float().cpu().numpy()
        err = max(float(np.abs(np.fromfile(rec["A_emb"], np.float32) - w).max())
                  for rec, w in zip(records, want))
        named = all(os.path.isfile(rec["A_emb"]) and rec["A_emb"].endswith("_emb.raw")
                    for rec in records)
        calls = -(-len(records) // 8)
        if n != len(records) or not named or not err <= EMB_TOL or \
                got["flash"] != TOWER_LAYERS * calls:
            raise AssertionError(f"precompute_embeddings: {n} of {len(records)} records, "
                                 f"files named {named}, max abs err {err}, launches {got}")
        emit({"phase": "encoders", "what": "instancediff_torch.tools.precompute_embeddings on "
                                           "the card: a seeded ViT-B/16 open_clip state dict, "
                                           "SpeckleMed phantoms at 224 px, batch 8",
              "records": n, "distinct_images": len({rec["A"] for rec in records}),
              "max_abs_err_vs_tower": err, "tol": EMB_TOL, "index_names_every_file": named,
              "seconds": round(seconds, 3), "launches": dict(got), "gpu": gpu})
        del model
    got["flash_tower"], got["flash"] = got["flash"], 0
    return got


def encoders_phase(gpu, gen, worst) -> tuple:
    """Phase ``encoders``: the flash kernel at the image tower's shapes
    against its plain version (with bound and SDPA's time; the errors go
    into ``worst["flash"]``), the on-device image context, the BiomedCLIP
    paths and precompute_embeddings. Returns the launches of the runs that
    count in the kernels line (the tower's flash launches as
    ``flash_tower``) and the tower's shapes' measurements."""
    tower = []
    for shape, dtype in TOWER_FLASH_SHAPES:
        m = measure_flash(shape, dtype, gen)
        worst["flash"] = max(worst["flash"], m["max_abs_err"])
        emit({"phase": "encoders", "kernel": NAMES["flash"], "shape": list(shape),
              "what": "the image tower's attention", "dtype": str(dtype), "tol": TOL[dtype],
              "per_call_launches": TOWER_LAYERS, **m, "gpu": gpu})
        tower.append(dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""), **m))
    total = serve_with_tower(gpu)
    total.update(biomedclip_paths(gpu))
    total.update(precompute_phase(gpu))
    return total, tower


# ---------------------------------------------------------------- towers

# phase ``towers``: OpenAI RN50 (load_openai_model's own geometry read from
# the checkpoint), the OpenAI ViT-B/16, BiomedCLIP at fp16, the dense ViT
# and the context decoders, batch 8 at 224 px
TOWER_BATCH = 8
RN50 = dict(layers=(3, 4, 6, 3), width=64, embed=1024)
CLIP_TEXT = dict(width=512, layers=12, vocab=49408, ctx=77)
DENSE_RES = (224, 320)  # the table's 14x14 grid and an off-grid 20x20 one
# unit-norm embeddings at fp16 against the fp32 model's (fp16 rounds every
# matmul input and output: 2^-11 relative, summed over 12 blocks)
FP16_TOL = 1e-2


def openai_state_dict(rng, visual: str) -> dict:
    """A seeded random OpenAI CLIP state dict in the checkpoint's own key
    layout: the text tower (``token_embedding``, 77 positions,
    ``transformer.resblocks.*`` with ``in_proj_weight``, ``ln_final``,
    ``text_projection``), ``logit_scale``, and the visual tower of
    ``visual``: "rn50" (``visual.conv1..3``/``bn1..3``, ``visual.layer{s}.
    {b}.*`` with ``downsample.0/.1``, ``visual.attnpool.*`` over a 7x7
    grid) or "vit_b16" (``visual.conv1``, ``class_embedding``, 197
    positions, ``ln_pre``, 12 resblocks, ``ln_post``, ``proj``). Weights ~
    N(0, 1/fan_in), norm scales and BatchNorm variances ~ 1 + 0.1 N, the
    rest ~ 0.1 N (tables 0.02 N)."""
    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape, dtype=np.float32)
                                 / np.sqrt(int(np.prod(shape[1:])))))

    def n(*shape, scale=0.1, mean=0.0):
        return torch.from_numpy(mean + scale * rng.standard_normal(shape, dtype=np.float32))

    sd = {}

    def resblocks(prefix, width, layers):
        for i in range(layers):
            R = f"{prefix}transformer.resblocks.{i}."
            sd.update({R + "attn.in_proj_weight": w(3 * width, width),
                       R + "attn.in_proj_bias": n(3 * width),
                       R + "attn.out_proj.weight": w(width, width),
                       R + "attn.out_proj.bias": n(width),
                       R + "mlp.c_fc.weight": w(4 * width, width), R + "mlp.c_fc.bias": n(4 * width),
                       R + "mlp.c_proj.weight": w(width, 4 * width), R + "mlp.c_proj.bias": n(width),
                       R + "ln_1.weight": n(width, mean=1.0), R + "ln_1.bias": n(width),
                       R + "ln_2.weight": n(width, mean=1.0), R + "ln_2.bias": n(width)})

    def bn(key, c):
        sd.update({key + ".weight": n(c, mean=1.0), key + ".bias": n(c),
                   key + ".running_mean": n(c), key + ".running_var": n(c, mean=1.0)})

    tw = CLIP_TEXT["width"]
    embed = RN50["embed"] if visual == "rn50" else 512
    sd.update({"token_embedding.weight": n(CLIP_TEXT["vocab"], tw, scale=0.02),
               "positional_embedding": n(CLIP_TEXT["ctx"], tw, scale=0.01),
               "ln_final.weight": n(tw, mean=1.0), "ln_final.bias": n(tw),
               "text_projection": w(embed, tw).T.contiguous(),
               "logit_scale": torch.tensor(float(np.log(1 / 0.07)))})
    resblocks("", tw, CLIP_TEXT["layers"])
    if visual == "rn50":
        width = RN50["width"]
        for i, (cin, cout) in enumerate(((3, width // 2), (width // 2, width // 2),
                                         (width // 2, width)), 1):
            sd[f"visual.conv{i}.weight"] = w(cout, cin, 3, 3)
            bn(f"visual.bn{i}", cout)
        inp = width
        for s, blocks in enumerate(RN50["layers"]):
            planes = width * 2 ** s
            for b in range(blocks):
                L = f"visual.layer{s + 1}.{b}"
                sd[f"{L}.conv1.weight"] = w(planes, inp, 1, 1)
                sd[f"{L}.conv2.weight"] = w(planes, planes, 3, 3)
                sd[f"{L}.conv3.weight"] = w(planes * 4, planes, 1, 1)
                for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                    bn(f"{L}.bn{j}", c)
                if b == 0:
                    sd[f"{L}.downsample.0.weight"] = w(planes * 4, inp, 1, 1)
                    bn(f"{L}.downsample.1", planes * 4)
                inp = planes * 4
        C = width * 32
        sd["visual.attnpool.positional_embedding"] = n(50, C, scale=C ** -0.5)
        for name in ("q_proj", "k_proj", "v_proj"):
            sd[f"visual.attnpool.{name}.weight"], sd[f"visual.attnpool.{name}.bias"] = \
                w(C, C), n(C)
        sd["visual.attnpool.c_proj.weight"], sd["visual.attnpool.c_proj.bias"] = \
            w(embed, C), n(embed)
    else:
        vw = 768
        sd.update({"visual.conv1.weight": w(vw, 3, 16, 16), "visual.class_embedding": n(vw),
                   "visual.positional_embedding": n(197, vw, scale=0.02),
                   "visual.ln_pre.weight": n(vw, mean=1.0), "visual.ln_pre.bias": n(vw),
                   "visual.ln_post.weight": n(vw, mean=1.0), "visual.ln_post.bias": n(vw),
                   "visual.proj": w(embed, vw).T.contiguous()})
        resblocks("visual.", vw, 12)
    return sd


class _Buffers(torch.nn.Module):
    def forward(self, x):
        return x


def save_torchscript(sd, path) -> None:
    """``sd`` as a ``torch.jit.save``d archive of nested modules holding its
    tensors as buffers, as OpenAI ships its checkpoints."""
    root = _Buffers()
    for key, value in sd.items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, _Buffers())
            m = getattr(m, name)
        m.register_buffer(leaf, value)
    torch.jit.save(torch.jit.script(root), path)


@contextlib.contextmanager
def tower_flash_shapes(plain: bool = False):
    """While open, the towers' unmasked attention (``multi_head_flash`` as
    ``text_encoder`` and ``vision_towers`` call it) records each launch's
    ([B, H, N, D], dtype) into the yielded Counter, through the kernel or,
    with ``plain``, through its plain version."""
    from instancediff_torch.models import text_encoder as text_mod
    from instancediff_torch.models import vision_towers as vt_mod
    from instancediff_torch.ops import flash_attention as flash_mod

    seen = Counter()

    def rec(q, k, v, heads):
        B, N, C = q.shape
        seen[((B, heads, N, C // heads), q.dtype)] += 1
        if not plain:
            return flash_mod.multi_head_flash(q, k, v, heads)
        with mock.patch.object(flash_mod, "flash_attention", flash_attention_plain):
            return flash_mod.multi_head_flash(q, k, v, heads)

    with mock.patch.object(text_mod, "multi_head_flash", rec), \
            mock.patch.object(vt_mod, "multi_head_flash", rec):
        yield seen


def _leaves(out) -> list:
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def tower_err(what, got, want, tol) -> float:
    """The largest |got - want| over every output tensor, relative to
    max(1, the largest |want|); raises past ``tol`` or on a non-finite or
    misshapen output."""
    errs = []
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        g, w = g.float().cpu(), w.float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{what}: shape {tuple(g.shape)} vs {tuple(w.shape)} or not finite")
        errs.append((g - w).abs().max().item() / max(1.0, w.abs().max().item()))
    if not max(errs) <= tol:
        raise AssertionError(f"{what}: max relative err {max(errs)} > {tol}")
    return max(errs)


def towers_openai(gpu, tmp) -> tuple:
    """(a) ``load_openai_model`` on seeded RN50 and ViT-B/16 OpenAI
    checkpoints (``torch.save``d, the ViT once more as a ``torch.jit.save``d
    archive): 8 images at 224 px and the 5 prompts on the card against the
    same model on the CPU in fp32 (``FORWARD_TOL``), the flash launches per
    ``encode_image`` (1 for RN50's attention pool, 12 for the ViT), the
    archive's embeddings equal to the state dict's. Returns (launches by
    (shape, dtype), per-call shapes by path)."""
    from instancediff_torch.models.openai import load_openai_model

    images = np.random.default_rng(70).uniform(-1, 1, (TOWER_BATCH, 224, 224, 1)).astype(
        np.float32)
    texts = list(ARTIFACT_PROMPTS)
    launched, per_call = Counter(), {}
    for name, visual, per_image in (("rn50", "rn50", 1), ("vit_b16", "vit_b16", TOWER_LAYERS)):
        sd = openai_state_dict(np.random.default_rng(71 if visual == "rn50" else 72), visual)
        path = os.path.join(tmp, f"{name}.pt")
        torch.save(sd, path)
        paths = {"state_dict": path}
        if visual == "vit_b16":
            paths["torchscript"] = os.path.join(tmp, f"{name}_jit.pt")
            save_torchscript(sd, paths["torchscript"])
        del sd
        cpu, _ = load_openai_model(path, device="cpu")
        with torch.no_grad():
            want = cpu.encode_image(images), cpu.encode_text(texts)
        del cpu
        embs = {}
        for archive, p in paths.items():
            t0 = time.time()
            model, preprocess = load_openai_model(p, device="cuda")
            load_s = time.time() - t0
            before = flash_attention.launches
            with tower_flash_shapes() as seen:
                got = model.encode_image(images), model.encode_text(texts)
            torch.cuda.synchronize()
            calls = flash_attention.launches - before
            if calls != per_image or sum(seen.values()) != per_image:
                raise AssertionError(f"{name} ({archive}): {calls} flash launches per "
                                     f"encode_image, want {per_image}")
            launched.update(seen)
            per_call[f"openai_{name}"] = dict(seen)
            err = tower_err(f"{name} ({archive}) card vs CPU", got, want, FORWARD_TOL)
            embs[archive] = got
            pre = preprocess(np.random.default_rng(73).integers(0, 256, (256, 320, 3),
                                                                 dtype=np.uint8))
            emit({"phase": "towers", "what": f"(a) load_openai_model, OpenAI {name} "
                                             f"({archive}), fp32: {TOWER_BATCH} images at 224 "
                                             f"px and {len(texts)} prompts, card vs CPU",
                  "embed_dim": model.embed_dim, "visual": type(model.visual).__name__,
                  "rn_geometry": [RN50["width"], list(RN50["layers"])] if name == "rn50" else None,
                  "logit_scale": model.logit_scale, "load_seconds": round(load_s, 3),
                  "flash_per_encode_image": calls, "flash_shapes": [[list(s), str(d)] for
                                                                    (s, d) in seen],
                  "max_rel_err": err, "tol": FORWARD_TOL, "preprocess_shape": list(pre.shape),
                  "gpu": gpu})
            del model
        if "torchscript" in embs and not all(torch.equal(a, b) for a, b in
                                             zip(embs["torchscript"], embs["state_dict"])):
            raise AssertionError("the TorchScript archive's model differs from the state dict's")
        for p in paths.values():
            os.remove(p)
        torch.cuda.empty_cache()
    return launched, per_call


def towers_biomedclip_fp16(gpu) -> tuple:
    """(b) BiomedCLIP (ViT-B/16, PubMedBERT) at fp16 and pure_fp16 from the
    same seeded weights as at fp32, batch 8 at 224 px and the 5 prompts:
    unit-norm float16 embeddings within ``FP16_TOL`` of the fp32 model's,
    12 fp16 flash launches per ``encode_image``."""
    from instancediff_torch.models.biomedclip import get_BiomedCLIP
    from instancediff_torch.models.clip_vit import CLIPVisionTower
    from instancediff_torch.models.text_encoder import HFContextTextEncoder

    visual, text = CLIPVisionTower(), HFContextTextEncoder()
    randomize_(visual, seed=74)
    randomize_(text, seed=75)
    trees = dict(params=flax_params(visual), text_params=flax_params(text))
    del visual, text
    images = np.random.default_rng(76).uniform(-1, 1, (TOWER_BATCH, 224, 224, 1)).astype(
        np.float32)
    texts = list(ARTIFACT_PROMPTS)
    ref = get_BiomedCLIP(precision="fp32", device="cuda", **trees)
    want = ref.encode_image(images), ref.encode_text(texts)
    del ref
    launched, per_call = Counter(), {}
    for precision in ("fp16", "pure_fp16"):
        model = get_BiomedCLIP(precision=precision, device="cuda", **trees)
        before = flash_attention.launches
        with tower_flash_shapes() as seen:
            got = model.encode_image(images), model.encode_text(texts)
        torch.cuda.synchronize()
        calls = flash_attention.launches - before
        fp16 = sum(c for (_, d), c in seen.items() if d == torch.float16)
        if calls != TOWER_LAYERS or fp16 != TOWER_LAYERS or \
                any(g.dtype != torch.float16 for g in got):
            raise AssertionError(f"BiomedCLIP {precision}: {calls} flash launches ({fp16} "
                                 f"fp16), outputs {[g.dtype for g in got]}")
        err = tower_err(f"BiomedCLIP {precision} vs fp32", got, want, FP16_TOL)
        launched.update(seen)
        per_call[f"biomedclip_{precision}"] = dict(seen)
        emit({"phase": "towers", "what": f"(b) BiomedCLIP at {precision} against the same "
                                         f"weights at fp32: {TOWER_BATCH} images at 224 px and "
                                         f"{len(texts)} prompts",
              "flash_per_encode_image": calls, "fp16_launches": fp16,
              "flash_shapes": [[list(s), str(d)] for (s, d) in seen],
              "max_abs_err_unit_norm": err, "tol": FP16_TOL,
              "norms": [round(float(g.float().norm(dim=-1).max()), 4) for g in got], "gpu": gpu})
        del model
    torch.cuda.empty_cache()
    return launched, per_call


def towers_dense(gpu) -> tuple:
    """(c) ``CLIPDenseVisionTransformer`` at ViT-B/16 width (12 blocks of
    768, the patch-16 necks, ``get_embeddings``), batch 8, at 224 px and at
    an off-grid 320 px (the run-time bilinear position resize), then
    ``ContextDecoderRef`` (width 256, 6 layers, unscaled and scaled) and
    ``ContextDecoder`` (512, 3 layers) on its 224 px embeddings with 5 text
    queries; each against the same module on the CPU in fp32
    (``FORWARD_TOL``), with its flash launches (12 per tower call, 6 per
    ``ContextDecoderRef``, none for ``ContextDecoder``)."""
    from instancediff_torch.models.vision_towers import (CLIPDenseVisionTransformer,
                                                         ContextDecoder, ContextDecoderRef)

    tower = CLIPDenseVisionTransformer(get_embeddings=True).eval()
    randomize_(tower, seed=77)
    cuda = {"tower": copy.deepcopy(tower).cuda()}
    launched, per_call = Counter(), {}
    memory = None
    for res in DENSE_RES:
        x = torch.from_numpy(np.random.default_rng(78 + res).uniform(
            -1, 1, (TOWER_BATCH, res, res, 1)).astype(np.float32))
        with torch.no_grad():
            want = tower(x)
            before = flash_attention.launches
            with tower_flash_shapes() as seen:
                got = cuda["tower"](x.cuda())
            torch.cuda.synchronize()
        calls = flash_attention.launches - before
        if calls != TOWER_LAYERS:
            raise AssertionError(f"dense ViT {res} px: {calls} flash launches")
        err = tower_err(f"dense ViT {res} px card vs CPU", got, want, FORWARD_TOL)
        launched.update(seen)
        per_call[f"dense_vit_{res}"] = dict(seen)
        emit({"phase": "towers", "what": f"(c) CLIPDenseVisionTransformer ViT-B/16, patch-16 "
                                         f"necks and embeddings, {res} px, batch {TOWER_BATCH}, "
                                         "fp32, card vs CPU",
              "outputs": [list(t.shape) for t in _leaves(got)], "flash_per_call": calls,
              "flash_shapes": [[list(s), str(d)] for (s, d) in seen], "max_rel_err": err,
              "tol": FORWARD_TOL, "gpu": gpu})
        if res == 224:
            memory = want[4][1].reshape(TOWER_BATCH, -1, 512), got[4][1].reshape(
                TOWER_BATCH, -1, 512)
    del cuda, tower
    queries = torch.from_numpy(np.random.default_rng(79).standard_normal(
        (TOWER_BATCH, len(ARTIFACT_PROMPTS), 512)).astype(np.float32))
    for name, make, per_call_launches in (
            ("context_decoder_ref", lambda: ContextDecoderRef(), 6),
            ("context_decoder_ref_scaled", lambda: ContextDecoderRef(scaled=True), 6),
            ("context_decoder", lambda: ContextDecoder(), 0)):
        dec = make().eval()
        randomize_(dec, seed=80)
        dec_cuda = copy.deepcopy(dec).cuda()
        with torch.no_grad():
            want = dec(queries, memory[0])
            before = flash_attention.launches
            with tower_flash_shapes() as seen:
                got = dec_cuda(queries.cuda(), memory[1])
            torch.cuda.synchronize()
        calls = flash_attention.launches - before
        if calls != per_call_launches:
            raise AssertionError(f"{name}: {calls} flash launches, want {per_call_launches}")
        err = tower_err(f"{name} card vs CPU", got, want, FORWARD_TOL)
        launched.update(seen)
        if calls:
            per_call[name] = dict(seen)
        emit({"phase": "towers", "what": f"(c) {name} on the dense ViT's 224 px embeddings "
                                         f"[{TOWER_BATCH}, 196, 512], {len(ARTIFACT_PROMPTS)} "
                                         "text queries, fp32, card vs CPU",
              "flash_per_call": calls, "flash_shapes": [[list(s), str(d)] for (s, d) in seen],
              "max_rel_err": err, "tol": FORWARD_TOL, "gpu": gpu})
    torch.cuda.empty_cache()
    return launched, per_call


def towers_train_mode(gpu) -> Counter:
    """(d) One train-mode forward of the OpenAI ViT-B/16 tower with
    ``patch_dropout=0.5`` and ``drop_path_rate=0.1`` from a seeded CUDA
    generator, batch 8, 224 px, under no_grad: 1 + 98 tokens kept per image
    (the flash launches' N), and the same seed the same embedding."""
    from instancediff_torch.models.clip_vit import CLIPVisionTower

    tower = CLIPVisionTower(flavour="openai", patch_dropout=0.5, drop_path_rate=0.1)
    randomize_(tower, seed=81)
    tower = tower.cuda()
    x = torch.from_numpy(np.random.default_rng(82).uniform(
        -1, 1, (TOWER_BATCH, 224, 224, 1)).astype(np.float32)).cuda()
    outs = []
    with torch.no_grad(), tower_flash_shapes() as seen:
        for _ in range(2):
            outs.append(tower(x, deterministic=False,
                              rng=torch.Generator(device="cuda").manual_seed(83)))
        other = tower(x, deterministic=False, rng=torch.Generator(device="cuda").manual_seed(84))
        evaluated = tower(x)
    torch.cuda.synchronize()
    kept = sorted({s[2] for (s, _) in seen})
    if kept != [1 + 98, 197] or not torch.equal(outs[0], outs[1]) or \
            torch.equal(outs[0], other) or not torch.isfinite(outs[0]).all():
        raise AssertionError(f"train-mode ViT: tokens {kept}, same seed equal "
                             f"{torch.equal(outs[0], outs[1])}, another seed differs "
                             f"{not torch.equal(outs[0], other)}")
    emit({"phase": "towers", "what": "(d) train-mode OpenAI ViT-B/16, patch_dropout 0.5, "
                                     "drop_path_rate 0.1 (0 to 0.1 over the blocks), seeded "
                                     f"CUDA generator, batch {TOWER_BATCH}, 224 px, fp32",
          "tokens_per_image_train_eval": kept, "same_seed_equal": True,
          "other_seed_differs": True,
          "train_vs_eval_max_abs_diff": (outs[0] - evaluated).abs().max().item(), "gpu": gpu})
    del tower
    torch.cuda.empty_cache()
    return seen


def towers_phase(gpu, gen, worst) -> tuple:
    """Phase ``towers``: (a) ``towers_openai``, (b) ``towers_biomedclip_fp16``,
    (c) ``towers_dense``, (d) ``towers_train_mode``, then every distinct
    flash launch of (a)-(c) held against its plain version and timed, one
    ``per_forward`` line per tower path (the errors go into
    ``worst["flash_towers"]``). Returns (the phase's flash launches by
    dtype, the per-shape measurements)."""
    launched, per_call = Counter(), {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_towers_") as tmp:
        for got, calls in (towers_openai(gpu, tmp), towers_biomedclip_fp16(gpu),
                           towers_dense(gpu)):
            launched.update(got)
            per_call.update(calls)
    launched.update(towers_train_mode(gpu))
    measured = {}
    for path, shapes in per_call.items():
        tot, per_shape = Counter(), []
        for (shape, dtype), count in shapes.items():
            if (shape, dtype) not in measured:
                measured[(shape, dtype)] = measure_flash(shape, dtype, gen)
            m = measured[(shape, dtype)]
            per_shape.append([list(shape), str(dtype).replace("torch.", ""), count,
                              round(m["ms"], 4), round(m["device_ms"], 4),
                              round(m["bound_ms"], 4), round(m["library_ms"], 4)])
            for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += m[key] * count
            worst["flash_towers"] = max(worst["flash_towers"], m["max_abs_err"])
        emit({"phase": "per_forward", "kernel": "flash", "path": path,
              "launches_per_forward": sum(shapes.values()),
              **{k: round(v, 4) for k, v in tot.items()},
              "shapes_dtype_count_ms_device_bound_library": per_shape, "gpu": gpu})
    by_dtype = Counter()
    for (_, dtype), count in launched.items():
        by_dtype[str(dtype).replace("torch.", "")] += count
    per_shape = [dict(shape=list(s), dtype=str(d).replace("torch.", ""),
                      **{k: m[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err")})
                 for (s, d), m in measured.items()]
    return by_dtype, per_shape


# ---------------------------------------------------------------- CoCa

# coca_ViT-B-32 at JAX's defaults (build_coca()), and coca_ViT-L-14's widths
# (open_clip's config: embed 768; vision 1024 wide in 24 layers of 16
# heads, patch 14; text and decoder 768 wide, 12 heads; the pooler's 8 heads
# 96 wide), at full depth
COCA_L14 = dict(embed_dim=768, text_width=768, text_heads=12, mm_width=768, mm_heads=12,
                patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16)
COCA_BATCH, COCA_CTX, COCA_SEQ = 8, 76, 30
COCA_BEAMS, COCA_GROUPS = 6, 3
COCA_REGISTRY = ("coca_ViT-B-32", "laion2b_s13b_b90k")


@contextlib.contextmanager
def coca_flash(plain: bool = False):
    """While open, CoCa's unmasked attention (``multi_head_flash`` as
    ``coca`` and ``text_encoder`` call it) records each launch's ([B, H, Nq,
    Nk, D], dtype) into the yielded Counter, through the kernel or, with
    ``plain``, through its plain version."""
    from instancediff_torch.models import coca as coca_mod
    from instancediff_torch.models import text_encoder as text_mod
    from instancediff_torch.ops import flash_attention as flash_mod

    seen = Counter()

    def rec(q, k, v, heads):
        B, N, C = q.shape
        seen[((B, heads, N, k.shape[1], C // heads), q.dtype)] += 1
        if not plain:
            return flash_mod.multi_head_flash(q, k, v, heads)
        with mock.patch.object(flash_mod, "flash_attention", flash_attention_plain):
            return flash_mod.multi_head_flash(q, k, v, heads)

    with mock.patch.object(coca_mod, "multi_head_flash", rec), \
            mock.patch.object(text_mod, "multi_head_flash", rec):
        yield seen


def coca_state_dict(model) -> dict:
    """``model``'s parameters in open_clip's CoCa layout (fused ``in_proj``
    rows q | k | v, the pooler's separate ``q/k/v_proj_weight``, bias-free
    ``conv1``, projections as [in, out] matrices): the inverse of
    ``load_torch_coca_weights``."""
    sd = {}

    def put(key, t):
        sd[key] = t.detach().float().cpu().clone()

    def lin(prefix, m):
        put(prefix + ".weight", m.weight)
        put(prefix + ".bias", m.bias)

    def resblock(prefix, blk, cross=False):
        put(prefix + "attn.in_proj_weight", torch.cat([blk.q_proj.weight, blk.k_proj.weight,
                                                       blk.v_proj.weight]))
        put(prefix + "attn.in_proj_bias", torch.cat([blk.q_proj.bias, blk.k_proj.bias,
                                                     blk.v_proj.bias]))
        lin(prefix + "attn.out_proj", blk.out_proj)
        lin(prefix + "mlp.c_fc", blk.fc)
        lin(prefix + "mlp.c_proj", blk.proj)
        for ln in ("ln_1", "ln_1_kv", "ln_2") if cross else ("ln_1", "ln_2"):
            lin(prefix + ln, getattr(blk, ln))

    vis, txt, dec = model.visual, model.text, model.text_decoder
    put("visual.conv1.weight", vis.patch_embed.weight)
    put("visual.class_embedding", vis.class_token.reshape(-1))
    put("visual.positional_embedding", vis.pos_embed)
    lin("visual.ln_pre", vis.ln_pre)
    lin("visual.ln_post", vis.ln_post)
    put("visual.proj", vis.proj.weight.T)
    for i in range(vis.layers):
        resblock(f"visual.transformer.resblocks.{i}.", getattr(vis, f"block_{i}"))
    pool = vis.attn_pool
    put("visual.attn_pool.query", pool.query)
    lin("visual.attn_pool.ln_q", pool.ln_q)
    lin("visual.attn_pool.ln_k", pool.ln_k)
    for n in ("q", "k", "v"):
        put(f"visual.attn_pool.attn.{n}_proj_weight", getattr(pool, f"{n}_proj").weight)
    put("visual.attn_pool.attn.in_proj_bias", torch.cat([pool.q_proj.bias, pool.k_proj.bias,
                                                         pool.v_proj.bias]))
    lin("visual.attn_pool.attn.out_proj", pool.out_proj)
    put("text.token_embedding.weight", txt.token_embedding.weight)
    put("text.cls_emb", txt.cls_emb)
    put("text.positional_embedding", txt.positional_embedding)
    lin("text.ln_final", txt.ln_final)
    put("text.text_projection", txt.text_projection.weight.T)
    for i in range(txt.layers):
        resblock(f"text.transformer.resblocks.{i}.", getattr(txt, f"block_{i}"))
    for i in range(dec.layers):
        resblock(f"text_decoder.resblocks.{i}.", getattr(dec, f"block_{i}"))
        resblock(f"text_decoder.cross_attn.{i}.", getattr(dec, f"cross_{i}"), cross=True)
    lin("text_decoder.ln_final", dec.ln_final)
    put("text_decoder.text_projection", dec.text_projection.weight.T)
    put("logit_scale", model.logit_scale)
    return sd


def coca_ids(rng, vocab: int) -> torch.Tensor:
    """[COCA_BATCH, COCA_CTX] token ids: SOT, random tokens, EOT at a random
    length, then padding (0)."""
    from instancediff_torch.models.coca import EOS_ID, SOT_ID

    ids = np.zeros((COCA_BATCH, COCA_CTX), np.int64)
    for b, n in enumerate(rng.integers(4, COCA_CTX + 1, COCA_BATCH)):
        ids[b, 0], ids[b, n - 1] = SOT_ID, EOS_ID
        ids[b, 1:n - 1] = rng.integers(1, vocab - 2, n - 2)
    return torch.from_numpy(ids)


def caption_contract(what, out, eos: int, pad: int) -> None:
    """SOT first; after a row's first EOS or PAD only PAD; an unfinished row
    ends in EOS."""
    from instancediff_torch.models.coca import SOT_ID

    rows = out.cpu().numpy()
    if rows.shape != (COCA_BATCH, COCA_SEQ) or not (rows[:, 0] == SOT_ID).all():
        raise AssertionError(f"{what}: captions {rows.shape}, first tokens {rows[:, 0]}")
    for row in rows:
        stop = np.flatnonzero((row[1:] == eos) | (row[1:] == pad))
        if not len(stop) or not (row[1:][stop[0] + 1:] == pad).all():
            raise AssertionError(f"{what}: a caption breaks the EOS/PAD contract: {row}")


def hold_kernels(what, got, plain, dtype, ref32=None) -> dict:
    """Kernels against plain flash on the same outputs (lists of tensors):
    fp32 within ``TOL``; a 16-bit run, whose bf16 blocks amplify the kernel's
    rounding of P like any other rounding, no farther from the fp32 plain
    run ``ref32`` than max(``TOL``, 1.5x the 16-bit plain run's distance
    from it). Returns the errors (relative to the largest |output|)."""
    if ref32 is None:
        return {"kernels_vs_plain": tower_err(f"{what} kernels vs plain", got, plain,
                                              TOL[dtype]), "tol": TOL[dtype]}
    plain_err = tower_err(f"{what} plain vs fp32 plain", plain, ref32, float("inf"))
    tol = max(TOL[dtype], 1.5 * plain_err)
    return {"kernels_vs_plain": tower_err(f"{what} kernels vs plain", got, plain,
                                          float("inf")),
            "kernels_vs_fp32_plain": tower_err(f"{what} kernels vs fp32 plain", got, ref32, tol),
            "plain_vs_fp32_plain": plain_err, "tol": tol}


COCA_OUTPUTS = ("image_features", "text_features", "logits")


def coca_forward_check(what, model, images, ids, per_forward, gpu, want_cpu=None, ref32=None):
    """One forward through the kernels, its flash launches counted (they
    must be ``per_forward``), against the same forward on the plain flash
    (``hold_kernels``; ``ref32``: the fp32 plain outputs for a bf16 run)
    and, when given, the CPU's (``FORWARD_TOL``). Returns (outputs, the
    plain-flash outputs, launches by (shape, dtype))."""
    with torch.inference_mode():
        before = flash_attention.launches
        with coca_flash() as seen:
            got = model(images, ids)
        torch.cuda.synchronize()
        calls = flash_attention.launches - before
        with coca_flash(plain=True):
            plain = model(images, ids)
    if calls != per_forward or sum(seen.values()) != per_forward:
        raise AssertionError(f"{what}: {calls} flash launches per forward, want {per_forward}")
    row = {"phase": "coca", "what": what, "flash_per_forward": calls,
           "flash_shapes": [[list(s), str(d)] for (s, d) in seen],
           **hold_kernels(what, [got[k] for k in COCA_OUTPUTS],
                          [plain[k] for k in COCA_OUTPUTS], got["logits"].dtype,
                          None if ref32 is None else [ref32[k] for k in COCA_OUTPUTS]),
           "logits": list(got["logits"].shape), "logit_scale": got["logit_scale"].item()}
    if want_cpu is not None:
        row.update(card_vs_cpu=tower_err(f"{what} card vs CPU", [got[k] for k in COCA_OUTPUTS],
                                         [want_cpu[k] for k in COCA_OUTPUTS], FORWARD_TOL),
                   cpu_tol=FORWARD_TOL)
    emit(dict(row, gpu=gpu))
    return got, plain, seen


def coca_generate(gpu, model, images, seen_all) -> dict:
    """(b) captions on the card: greedy (top-k 1, ``COCA_SEQ`` tokens) held
    against the plain-flash run (the step logits on the kernels' captions
    within ``TOL``; equal tokens, or the first differing position's top-2
    margin below the logits' error), top-p from a seeded generator, beam
    search (``COCA_BEAMS`` beams in ``COCA_GROUPS`` groups); ms per
    caption. Returns the phase line's numbers."""
    from instancediff_torch.models import coca

    eos, pad = coca.EOS_ID, model.pad_id
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            r = fn()
        torch.cuda.synchronize()
        return r, (time.time() - t0) * 1e3 / COCA_BATCH

    greedy = dict(seq_len=COCA_SEQ, generation_type="top_k", top_k=1)
    gen = torch.Generator(device="cuda")
    with coca_flash() as seen:
        coca.generate(model, images, gen.manual_seed(0), **greedy)  # warm-up
        before = flash_attention.launches
        tokens, ms = timed(lambda: coca.generate(model, images, gen.manual_seed(0), **greedy))
        launches = flash_attention.launches - before
    seen_all.update(seen)
    with coca_flash(plain=True):
        plain_tokens, plain_ms = timed(lambda: coca.generate(model, images, gen.manual_seed(0),
                                                             **greedy))
    per_call = model.visual.layers + 1 + (COCA_SEQ - 1) * model.text_decoder.layers
    if launches != per_call:
        raise AssertionError(f"greedy captions: {launches} flash launches, want {per_call}")
    caption_contract("greedy captions", tokens, eos, pad)
    with torch.inference_mode():
        _, embs = model.encode_image(images)
        logits = model.decode(embs, tokens).float()
        with coca_flash(plain=True):
            _, plain_embs = model.encode_image(images)
            plain_logits = model.decode(plain_embs, tokens).float()
    logit_err = tower_err("greedy captions' step logits, kernels vs plain", logits, plain_logits,
                          TOL[torch.float32])
    differ = (tokens != plain_tokens).any(dim=1)
    first = []
    for b in torch.nonzero(differ).flatten().tolist():
        i = int(torch.nonzero(tokens[b] != plain_tokens[b])[0])
        row = coca._process_logits(logits[b:b + 1, i - 1], tokens[b:b + 1], i, eos, 5, 1.0)
        top2 = torch.topk(row[0], 2).values
        margin = (top2[0] - top2[1]).item()
        first.append([b, i, margin])
        if not margin <= logit_err * max(1.0, plain_logits.abs().max().item()):
            raise AssertionError(f"greedy captions differ at row {b}, position {i}, where the "
                                 f"top-2 margin {margin} exceeds the logits' error")
    out["greedy"] = {"ms_per_caption": ms, "plain_ms_per_caption": plain_ms,
                     "flash_launches": launches, "step_logits_kernels_vs_plain": logit_err,
                     "rows_equal_to_plain": int((~differ).sum()),
                     "first_difference_row_pos_margin": first,
                     "tokens_row0": tokens[0].tolist()}
    with coca_flash() as seen:
        top_p, ms = timed(lambda: coca.generate(model, images, gen.manual_seed(1),
                                                seq_len=COCA_SEQ, generation_type="top_p",
                                                top_p=0.9))
        seen_all.update(seen)
        caption_contract("top-p captions", top_p, eos, pad)
        out["top_p"] = {"ms_per_caption": ms, "top_p": 0.9, "tokens_row0": top_p[0].tolist()}
        before = flash_attention.launches
        beams, ms = timed(lambda: coca.generate(model, images, seq_len=COCA_SEQ,
                                                generation_type="beam_search",
                                                num_beams=COCA_BEAMS,
                                                num_beam_groups=COCA_GROUPS))
        launches = flash_attention.launches - before
    seen_all.update(seen)
    caption_contract("beam-search captions", beams, eos, pad)
    if launches != per_call:
        raise AssertionError(f"beam search: {launches} flash launches, want {per_call}")
    out["beam_search"] = {"ms_per_caption": ms, "beams": COCA_BEAMS, "groups": COCA_GROUPS,
                          "flash_launches": launches, "tokens_row0": beams[0].tolist()}
    return out


def coca_phase(gpu, gen, worst) -> tuple:
    """Phase ``coca``: (a) coca_ViT-B-32 at full width and depth (JAX's
    defaults, fp32): seeded weights written as an open_clip state dict, read
    back through the registry's converter (``pretrained.resolve_converter``:
    ``load_torch_coca_weights``) on the card and on the CPU, every
    parameter equal to the written one; the forward on 8 one-channel 224 px
    images and ids [8, 76] through the kernels (13 flash launches per
    ``encode_image``, 12 per decoder pass) against plain flash and the CPU;
    (b) ``coca_generate``; (c) the same forward in bf16 against the fp32
    one; (d) coca_ViT-L-14's widths at full depth, seeded on the card:
    ``encode_image`` (its pooler's 8 heads of 96 on the D = 96
    instantiation) and ``decode`` in fp32 and bf16 against plain flash;
    then every distinct flash launch held against its plain version and
    timed, one ``per_forward`` line per path (errors into
    ``worst["flash_coca"]``). Returns (the phase's flash launches by dtype,
    the per-shape measurements)."""
    from instancediff_torch.models import coca, pretrained

    t_phase = time.time()
    rng = np.random.default_rng(90)
    images = torch.from_numpy(rng.uniform(-1, 1, (COCA_BATCH, 224, 224, 1)).astype(np.float32))
    ids = coca_ids(rng, 49408)
    launched, per_call = Counter(), {}

    source = coca.build_coca(device="cpu")
    randomize_(source, seed=91)
    with torch.no_grad():
        source.visual.patch_embed.bias.zero_()  # open_clip's patch conv has no bias
    loader = pretrained.resolve_converter(pretrained.get_pretrained_cfg(*COCA_REGISTRY))
    if loader is not coca.load_torch_coca_weights:
        raise AssertionError(f"{COCA_REGISTRY}: the registry resolves {loader}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coca_") as tmp:
        path = os.path.join(tmp, "open_clip_pytorch_model.bin")
        sd = coca_state_dict(source)
        torch.save(sd, path)
        ckpt_bytes = os.path.getsize(path)
        del sd
        t0 = time.time()
        model = loader(coca.build_coca(device="cuda"), path)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        cpu = loader(coca.build_coca(device="cpu"), path)
    for (name, want), got in zip(source.state_dict().items(), model.state_dict().values()):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"coca_ViT-B-32: {name} did not load as written")
    del source
    emit({"phase": "coca", "what": "(a) coca_ViT-B-32 seeded weights as an open_clip state "
                                   "dict, loaded through the registry's converter",
          "converter": f"{loader.__module__}.{loader.__name__}", "checkpoint_bytes": ckpt_bytes,
          "load_seconds": round(load_s, 3),
          "parameters": sum(p.numel() for p in model.parameters()), "gpu": gpu})
    with torch.inference_mode():
        want_cpu = cpu(images, ids)
    del cpu
    images_d, ids_d = images.cuda(), ids.cuda()
    per_forward = model.visual.layers + 1 + model.text_decoder.layers
    fp32, fp32_plain, seen = coca_forward_check(
        "(a) coca_ViT-B-32 forward, fp32, 8 images at 224 px and ids [8, 76]", model, images_d,
        ids_d, per_forward, gpu, want_cpu)
    launched.update(seen)
    per_call["coca_b32_forward_fp32"] = dict(seen)

    seen_gen = Counter()
    captions = coca_generate(gpu, model, images_d, seen_gen)
    launched.update(seen_gen)
    per_call["coca_b32_captions_fp32 (greedy twice, top-p, beam search)"] = dict(seen_gen)
    emit({"phase": "coca", "what": f"(b) coca_ViT-B-32 captions on the card, {COCA_BATCH} "
                                   f"images, {COCA_SEQ} tokens, fp32", **captions, "gpu": gpu})

    cast_compute_(model, torch.bfloat16, master=True)
    bf16, bf16_plain, seen = coca_forward_check("(c) coca_ViT-B-32 forward, bf16", model,
                                                images_d, ids_d, per_forward, gpu,
                                                ref32=fp32_plain)
    launched.update(seen)
    per_call["coca_b32_forward_bf16"] = dict(seen)
    # the unit-norm latents within the towers phase's 16-bit tolerance of
    # fp32; the logits (through 36 bf16 blocks) within BF16_FORWARD_TOL, or
    # no farther than 1.5x the plain-flash bf16 forward's own distance
    keys = ("image_features", "text_features")
    bf16_err = tower_err("coca_ViT-B-32 bf16 vs fp32 latents", [bf16[k] for k in keys],
                         [fp32[k] for k in keys], FP16_TOL)
    plain_logits_err = tower_err("coca_ViT-B-32 bf16 vs fp32 logits, plain flash",
                                 bf16_plain["logits"], fp32_plain["logits"], 1.0)
    logits_tol = max(BF16_FORWARD_TOL, 1.5 * plain_logits_err)
    logits_err = tower_err("coca_ViT-B-32 bf16 vs fp32 logits", bf16["logits"], fp32["logits"],
                           logits_tol)
    emit({"phase": "coca", "what": "(c) coca_ViT-B-32 bf16 forward against the fp32 one",
          "latents_max_rel_err": bf16_err, "latents_tol": FP16_TOL,
          "logits_max_rel_err": logits_err, "logits_tol": logits_tol,
          "plain_flash_logits_max_rel_err": plain_logits_err, "gpu": gpu})
    del model, fp32, bf16, fp32_plain, bf16_plain, want_cpu
    torch.cuda.empty_cache()

    with torch.device("cuda"):
        large = coca.CoCa(**COCA_L14)
    randomize_(large, seed=92)
    ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        cast_compute_(large, dtype, master=True)
        name = f"coca_l14_{str(dtype).replace('torch.', '')}"
        with torch.inference_mode():
            before = flash_attention.launches
            with coca_flash() as seen:
                latent, embs = large.encode_image(images_d)
                got = [latent, embs, large.decode(embs, ids_d)]
            torch.cuda.synchronize()
            calls = flash_attention.launches - before
            with coca_flash(plain=True):
                latent, embs = large.encode_image(images_d)
                plain = [latent, embs, large.decode(embs, ids_d)]
        want_calls = large.visual.layers + 1 + large.text_decoder.layers
        if calls != want_calls or sum(seen.values()) != want_calls:
            raise AssertionError(f"{name}: {calls} flash launches, want {want_calls}")
        if ((large.visual.attn_pool.n_head, 256, 257, 96), dtype) not in {
                ((s[1], s[2], s[3], s[4]), d) for s, d in seen}:
            raise AssertionError(f"{name}: the pooler did not run at D = 96: {seen}")
        errs = hold_kernels(name, got, plain, dtype, ref32)
        ref32 = ref32 or plain
        launched.update(seen)
        per_call[name] = dict(seen)
        emit({"phase": "coca", "what": f"(d) coca_ViT-L-14 widths, full depth, "
                                       f"{str(dtype).replace('torch.', '')}: encode_image and "
                                       "decode on ids [8, 76], kernels vs plain flash",
              "flash_per_call": calls, "flash_shapes": [[list(s), str(d)] for (s, d) in seen],
              **errs, "gpu": gpu})
    del large
    torch.cuda.empty_cache()

    measured = {}
    for path, shapes in per_call.items():
        tot, per_shape = Counter(), []
        for (shape, dtype), count in shapes.items():
            if (shape, dtype) not in measured:
                measured[(shape, dtype)] = measure_flash(shape, dtype, gen)
            m = measured[(shape, dtype)]
            per_shape.append([list(shape), str(dtype).replace("torch.", ""), count,
                              round(m["ms"], 4), round(m["device_ms"], 4),
                              round(m["bound_ms"], 4), round(m["library_ms"], 4)])
            for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] += m[key] * count
            worst["flash_coca"] = max(worst["flash_coca"], m["max_abs_err"])
        emit({"phase": "per_forward", "kernel": "flash", "path": path,
              "launches_per_forward": sum(shapes.values()),
              **{k: round(v, 4) for k, v in tot.items()},
              "shapes_nq_nk_dtype_count_ms_device_bound_library": per_shape, "gpu": gpu})
    pooler = (COCA_BATCH, 8, 256, 257, 96)
    measured[(pooler, torch.float16)] = m = measure_flash(pooler, torch.float16, gen)
    emit({"phase": "coca", "what": "the coca_ViT-L-14 pooler's shape in fp16", "shape": pooler,
          **m, "tol": TOL[torch.float16], "gpu": gpu})
    by_dtype = Counter()
    for (_, dtype), count in launched.items():
        by_dtype[str(dtype).replace("torch.", "")] += count
    per_shape = [dict(shape=list(s), dtype=str(d).replace("torch.", ""),
                      **{k: m[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err")})
                 for (s, d), m in measured.items()]
    emit({"phase": "coca", "what": "the phase", "seconds": round(time.time() - t_phase, 3),
          "flash_launches_by_dtype": dict(by_dtype), "gpu": gpu})
    return by_dtype, per_shape


# ---------------------------------------------------------------- training

TRAIN_CONFIGS = {"drift_fp32": "Configurations/flagship_tpu.yml",
                 "drift_bf16": "Configurations/flagship_bf16_tpu.yml",
                 "ddpm": "Configurations/flagship_ddpm_tpu.yml"}
# the drift fp32 run: 2 epochs of TRAIN_SAVE iterations at the configs' batch
# 4 (cut from 2 of 6, then of 4, for the script's time), a checkpoint at each
# epoch's end (where a resume re-enters), inline validation at the end; bf16
# and DDPM: one epoch of SHORT_ITERS, validated at its end; TIMED_STEPS (cut
# from 6) timed after 2 warm-ups
TRAIN_ITERS, TRAIN_SAVE, SHORT_ITERS, TIMED_STEPS = 6, 3, 4, 4
# the CUDA-vs-CPU gradient check: a narrower drift engine, fp32, the tiny text tower
GRAD_NET = dict(in_nc=2, out_nc=5, nf=64, ch_mult=[1, 2], num_res_blocks=2, context_dim=512,
                text_module="scoremap", score_map_chan=16)
GRAD_RES, GRAD_B = 64, 2
# gradients per leaf (``parity.check_grads``): GRAD_TOL of the leaf's largest,
# the score heads' scalar reductions REDUCTION_TOL, a leaf that cancels to
# roundoff GRAD_FLOOR of the largest other leaf; parameters within GRAD_TOL
# of each leaf's largest, but for at most ADAM_SHARE of the elements, which
# may take Adam's allowance (``parity.check_params``)
GRAD_TOL, GRAD_FLOOR, REDUCTION_TOL, ADAM_SHARE = 1e-4, 1e-5, 2e-3, 1e-5


def train_config(tmp, name, index, iters, nepoch, save_freq, val_freq, **extra) -> str:
    """A copy of ``TRAIN_CONFIGS[name]`` in ``tmp``: its train split the
    phantoms of ``index`` cut to ``iters`` batches per epoch, its val split
    one phantom, the experiment under ``tmp`` (``extra``: more ``path``
    keys), ``nepoch`` epochs and the cadences given."""
    with open(TRAIN_CONFIGS[name]) as f:
        opt = yaml.safe_load(f)
    train_ds, val_ds = opt["datasets"]["train"], opt["datasets"]["val"]
    train_ds.update(dataset_file=index, max_dataset_size=iters * train_ds["batch_size"])
    val_ds.update(dataset_file=index, max_dataset_size=1)
    opt["path"].update(root=tmp, **extra)
    opt["train"].update(val_freq=val_freq, nepoch=nepoch)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=save_freq)
    path = os.path.join(tmp, f"{name}{'_resume' if extra else ''}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


@contextlib.contextmanager
def timed_steps():
    """While open, every ``optimize_parameters`` is timed with the device
    drained before and after, and the kernels it launched counted; yields
    the list of (ms, loss, launches)."""
    from instancediff_torch.models.engine import SamplingEngine

    real = SamplingEngine.optimize_parameters
    rec = []

    def timed(self, *args, **kwargs):
        before = sum(read_launches().values())
        torch.cuda.synchronize()
        t = time.time()
        loss = real(self, *args, **kwargs)
        torch.cuda.synchronize()
        rec.append(((time.time() - t) * 1e3, loss, sum(read_launches().values()) - before))
        return loss

    with mock.patch.object(SamplingEngine, "optimize_parameters", timed):
        yield rec


def profile_train_step(eng, data, unprofiled_ms: float) -> dict:
    """One train step under torch.profiler, alone on the device (a
    synchronise before and after): its wall, the device time of its kernels
    by class (``KERNEL_CLASSES``), the idle share against that wall and
    against ``unprofiled_ms`` (the median step without the profiler), the
    kernels launched and the host's busiest ops."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng.optimize_parameters(data, gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_class, n = Counter(), 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                     False):
            continue
        name = e.name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)),
                   "elementwise_other")
        by_class[cls] += e.time_range.elapsed_us() / 1e3
        n += 1
    busy = sum(by_class.values())
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"profiled_step_wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy, 3),
            "idle_share_of_profiled_wall": round(1 - busy / wall_ms, 4),
            "unprofiled_median_ms": unprofiled_ms,
            "idle_share_of_unprofiled_median": round(1 - busy / unprofiled_ms, 4),
            "kernels_launched": n,
            "device_ms_by_class": {k: round(v, 3) for k, v in by_class.most_common()},
            "top_host_ops_self_ms_calls": {e.key[:60]: [round(e.self_cpu_time_total / 1e3, 3),
                                                        e.count] for e in host[:6]}}


def run_trainum(cfg):
    """``tools/trainUM`` on ``cfg`` on the card, its log kept out of stdout
    (it is in the experiment's directory); returns the engine."""
    with contextlib.redirect_stdout(io.StringIO()):
        return trainUM.main(["-opt", cfg])


def step_summary(rec, batch) -> dict:
    """Median ms per train step after 2 warm-up steps, img/s, the first and
    last losses, and the kernels the steps launched (must be 0)."""
    ms = statistics.median(r[0] for r in rec[2:])
    return {"steps": len(rec), "ms_per_step": round(ms, 3),
            "train_img_per_s": round(batch * 1e3 / ms, 3), "loss_first": rec[0][1],
            "loss_last": rec[-1][1], "kernel_launches_in_train_steps": sum(r[2] for r in rec)}


def training_diff(a, b) -> float:
    """Max abs difference of two engines' nets (online and EMA) and Adam
    moments and steps."""
    diff = 0.0
    for key in a.nets:
        for p, q in zip(a.nets[key].parameters(), b.nets[key].parameters()):
            diff = max(diff, (p - q).abs().max().item())
    for key, opt in a.optimizers.items():
        for p, q in zip(a.nets[key].parameters(), b.nets[key].parameters()):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                diff = max(diff, (opt.state[p][k] - b.optimizers[key].state[q][k]).abs()
                           .max().item())
    return diff


def grad_check(gpu) -> None:
    """One drift train step at ``GRAD_NET``'s widths, fp32, from one seeded
    state with injected timesteps and noise, on the card and on the CPU,
    TF32 off: the loss, every gradient leaf by leaf and the updated
    parameters (``parity.check_grads`` and ``check_params`` with the
    tolerances of ``GRAD_TOL``). A gradient a CUDA path dropped or got wrong
    fails it."""
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    try:
        rng = np.random.default_rng(50)
        batch = {"input": rng.uniform(-1, 1, (GRAD_B, GRAD_RES, GRAD_RES, 1)).astype(np.float32),
                 "target": rng.uniform(-1, 1, (GRAD_B, GRAD_RES, GRAD_RES, 1)).astype(np.float32),
                 "type_idx": np.array([0, 3]), "A_emb": rng.standard_normal(
                     (GRAD_B, 1, 512)).astype(np.float32)}
        t = torch.tensor([3, 71])
        noise = torch.tensor(rng.standard_normal((GRAD_B, GRAD_RES, GRAD_RES, 1)),
                             dtype=torch.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            eng = CLIPDriftEngine(GRAD_NET, GRAD_NET, score_map_ch_mult=(1, 1),
                                  sde=DriftSDE(T=T, max_sigma=0.4), tiny_text_encoder=True,
                                  device=dev, if_train=True, image_size=GRAD_RES,
                                  drift_net_lr=1e-4, noise_net_lr=1e-4)
            rng_w = np.random.default_rng(51)
            for key in ("drift", "noise"):
                load_flax_params(eng.nets[key], seeded_tree(flax_params(eng.nets[key]), rng_w))
            load_flax_params(eng.text_encoder, seeded_tree(flax_params(eng.text_encoder), rng_w))
            loss = eng.optimize_parameters(batch, t=t, std_noise=noise)
            out[dev] = (loss, {k: {n: (p.grad.float().cpu().numpy(), p.detach().cpu().numpy())
                                   for n, p in eng.nets[k].named_parameters()}
                               for k in ("drift", "noise")}, eng.lr0)
            del eng
        (loss_g, nets_g, lr0), (loss_c, nets_c, _) = out["cuda"], out["cpu"]
        read = {}
        for key in nets_c:
            g_c, p_c = ({n: v[i] for n, v in nets_c[key].items()} for i in (0, 1))
            g_g, p_g = ({n: v[i] for n, v in nets_g[key].items()} for i in (0, 1))
            if not all(np.isfinite(g).all() for g in g_g.values()):
                raise AssertionError(f"train step on the card: a {key} gradient is not finite")
            what = f"train step on the card vs the CPU: {key} "
            tols, read[key + "_gradients"] = check_grads(g_g, g_c, GRAD_TOL, GRAD_FLOOR,
                                                         REDUCTION_TOL, what=what)
            n = sum(v.size for v in p_c.values())
            read[key + "_parameters"] = check_params(
                p_g, p_c, GRAD_TOL, [(lr0[key], g_c, tols)], max(16, int(ADAM_SHARE * n)),
                what=what)
        lerr = abs(loss_g - loss_c) / abs(loss_c)
        if lerr > GRAD_TOL:
            raise AssertionError(f"train step loss on the card {loss_g}, on the CPU {loss_c}")
        emit({"phase": "train", "what": "one drift train step on the card against the CPU, "
                                        f"fp32, TF32 off, nf 64, ch_mult [1,2], {GRAD_RES} px, "
                                        f"batch {GRAD_B}, injected t and noise",
              "loss_cuda": loss_g, "loss_cpu": loss_c, "loss_rel_err": lerr, **read,
              "tols": {"grad_of_leaf": GRAD_TOL, "floor_of_largest_leaf": GRAD_FLOOR,
                       "reductions_of_leaf": REDUCTION_TOL, "params_of_leaf": GRAD_TOL,
                       "adam_allowance_share": ADAM_SHARE},
              "seconds": round(time.time() - t0, 3), "gpu": gpu})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def train_phase(gpu) -> None:
    """The training path: ``tools/trainUM`` on the card at flagship width
    (224 px, batch 4, the configs' nets) over SpeckleMed phantoms. Drift
    fp32, remat on: ``TRAIN_ITERS`` iterations with checkpoints every
    ``TRAIN_SAVE`` and inline validation at the end, then resumed from the
    first checkpoint to the end, whose nets, EMA and Adam
    moments must equal the uninterrupted run's; these two runs alone under
    cuDNN deterministic (its default backward algorithms are not
    repeatable). Everything after runs at PyTorch's defaults: the bundle
    served through ``Restorer.from_config``; one more step on the trained
    engine, after which the sampler's graph is captured anew and agrees
    with the eager loop; ``TIMED_STEPS`` steps of a fresh engine with remat
    on and with remat off (ms per step, img/s, peak memory), one of each
    profiled; drift bf16 and DDPM through trainUM for 4 iterations each
    (timed, validated inline, parameters and moments fp32, one step
    profiled); the gradient check. Kernels run only in validation and
    serving, with the per-step counts of ``PATHS``; the train steps launch
    none. The phase's launches (the eager comparison's apart) are printed
    in its own line."""
    total = Counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN convs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        index = write_speckle_med(os.path.join(tmp, "data"), 5, 224, 512, ARTIFACT_PROMPTS)
        images = np.random.default_rng(5).uniform(-1, 1, (4, 224, 224, 1)).astype(np.float32)
        data = {"input": images, "target": images[::-1].copy(), "type_idx": np.arange(4),
                "A_emb": np.zeros((4, 1, 512), np.float32)}
        zero_launches()
        t_phase = time.time()
        epochs = TRAIN_ITERS // TRAIN_SAVE
        cfg = train_config(tmp, "drift_fp32", index, TRAIN_SAVE, epochs, TRAIN_SAVE,
                           TRAIN_ITERS)
        state_dir = os.path.join(tmp, "experiments", "flagship_224", "training_state")
        # the resumed run neither validates nor checkpoints before its end
        cfg_b = train_config(tmp, "drift_fp32", index, TRAIN_SAVE, epochs, 10**6, 10**6,
                             resume_state=os.path.join(state_dir, f"{TRAIN_SAVE}.state"))
        torch.backends.cudnn.deterministic = True
        try:
            with timed_steps() as rec_a:
                whole = run_trainum(cfg)
            with timed_steps() as rec_b:
                resumed = run_trainum(cfg_b)
        finally:
            torch.backends.cudnn.deterministic = False
        diff = training_diff(whole, resumed)
        if diff != 0 or whole.step != TRAIN_ITERS or not resumed.ema_restored:
            raise AssertionError(f"resumed run differs from the uninterrupted one by {diff}")
        del resumed
        val = whole.last_graph
        if {k: val.launches[NAMES[k]] for k in PATHS["drift"]} != PATHS["drift"]:
            raise AssertionError(f"inline validation launches per step {val.launches}")
        summary = step_summary(rec_a, 4)
        emit({"phase": "train", "what": "trainUM drift fp32 flagship_tpu.yml, 224 px, "
                                        f"batch 4, remat on: {TRAIN_ITERS} iterations, then "
                                        f"resumed from {TRAIN_SAVE} to {TRAIN_ITERS}, both runs "
                                        "under cuDNN deterministic",
              "steps": summary["steps"], "loss_first": summary["loss_first"],
              "loss_last": summary["loss_last"],
              "ms_per_step_cudnn_deterministic": summary["ms_per_step"],
              "kernel_launches_in_train_steps": summary["kernel_launches_in_train_steps"],
              "resumed_steps": len(rec_b), "resume_max_abs_diff": diff,
              "ema_restored": True, "validation_launches_per_step": val.launches,
              "seconds_both_runs": round(time.time() - t_phase, 3), "gpu": gpu})

        t0 = time.time()
        models = os.path.join(tmp, "experiments", "flagship_224", "models")
        r = Restorer.from_config(cfg, pth_dir=models, iteration="latest", batch_size=2,
                                 sample_steps=BUNDLE_STEPS, device="cuda")
        served = r.restore(images[:2], ["speckle in OCT", "noise in low dose CT"])
        per_step = {k: r.engine.last_graph.launches[NAMES[k]] for k in PATHS["drift"]}
        if per_step != PATHS["drift"] or not np.isfinite(served).all():
            raise AssertionError(f"trained bundle served: launches per step {per_step}")
        del r

        batch = {k: v[:2] for k, v in data.items()}
        whole.test(batch, torch.Generator(device="cuda").manual_seed(3),
                   sample_steps=BUNDLE_STEPS, use_ema=False)  # captures the online nets
        captures = whole.captures
        whole.optimize_parameters(data, torch.Generator(device="cuda").manual_seed(9))
        got = whole.test(batch, torch.Generator(device="cuda").manual_seed(3),
                         sample_steps=BUNDLE_STEPS, use_ema=False)
        graph = whole.last_graph
        before = Counter(read_launches())
        want = whole.test(batch, torch.Generator(device="cuda").manual_seed(3),
                          sample_steps=BUNDLE_STEPS, use_ema=False, compiled=False)
        eager = Counter(read_launches())
        eager.subtract(before)  # the eager comparison is counted apart
        if whole.captures != captures + 1:
            raise AssertionError("no new capture after the weights were updated")
        emit({"phase": "train", "what": "the trained bundle served through "
                                        "Restorer.from_config (2 images, 4 steps), and "
                                        "the trained engine's sampler (online nets) after "
                                        "one more train step: recaptured, graph vs eager, "
                                        "fp32",
              "from_config_launches_per_step": per_step, "recaptured": True,
              **check_graph_vs_eager("trained engine", got, want, torch.float32),
              "launches_per_step": graph.launches, "seconds": round(time.time() - t0, 3),
              "gpu": gpu})
        del whole, got, want
        torch.cuda.empty_cache()

        # fresh engines of the same config, remat on and off
        opt = load_options(TRAIN_CONFIGS["drift_fp32"])
        for remat in (True, False):
            eng = create_model(opt["train"], opt["models"]["DriftNoise"],
                               sde=create_sde(opt["sdes"]["driftSDE"]), image_size=224,
                               remat=remat, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gen = torch.Generator(device="cuda").manual_seed(0)
            with timed_steps() as rec:
                for _ in range(TIMED_STEPS):
                    eng.optimize_parameters(data, gen)
            summary = step_summary(rec, 4)
            if summary["kernel_launches_in_train_steps"]:
                raise AssertionError("a train step launched a CUDA kernel")
            what = f"drift fp32 train step, flagship_tpu.yml, 224 px, batch 4, remat " \
                   f"{'on' if remat else 'off'}"
            emit({"phase": "train", "what": what, **summary,
                  "max_memory_allocated_gib": round(
                      torch.cuda.max_memory_allocated() / 2**30, 3), "gpu": gpu})
            emit({"phase": "train", "what": "profile: one " + what,
                  **profile_train_step(eng, data, summary["ms_per_step"]), "gpu": gpu})
            del eng
            torch.cuda.empty_cache()

        for name in ("drift_bf16", "ddpm"):
            t0 = time.time()
            cfg = train_config(tmp, name, index, SHORT_ITERS, 1, SHORT_ITERS, SHORT_ITERS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with timed_steps() as rec:
                eng = run_trainum(cfg)
            peak = torch.cuda.max_memory_allocated() / 2**30
            summary = step_summary(rec, 4)
            path = "ddpm" if name == "ddpm" else "drift"
            val = {k: eng.last_graph.launches[NAMES[k]] for k in PATHS[path]}
            fp32 = all(p.dtype == torch.float32 for p in eng.nets.parameters()) and all(
                st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
                for opt_ in eng.optimizers.values() for st in opt_.state.values())
            if summary["kernel_launches_in_train_steps"] or val != PATHS[path] or not fp32 \
                    or not np.isfinite(summary["loss_last"]):
                raise AssertionError(f"{name}: {summary}, validation launches {val}, "
                                     f"fp32 parameters and moments {fp32}")
            emit({"phase": "train", "what": f"trainUM {os.path.basename(TRAIN_CONFIGS[name])}, "
                                            f"224 px, batch 4, {SHORT_ITERS} iterations, "
                                            "validated inline",
                  **summary, "max_memory_allocated_gib": round(peak, 3),
                  "params_and_moments_fp32": fp32, "validation_launches_per_step": val,
                  "seconds": round(time.time() - t0, 3), "gpu": gpu})
            emit({"phase": "train", "what": f"profile: one {name} train step, 224 px, batch 4",
                  **profile_train_step(eng, data, summary["ms_per_step"]), "gpu": gpu})
            del eng
            torch.cuda.empty_cache()
        total.update(read_launches())
        total.subtract(eager)
    torch.backends.cudnn.allow_tf32 = tf32
    if not all(total[k] for k in WRAPPERS):
        raise AssertionError(f"the train phase's validation and serving launched {total}")
    emit({"phase": "train", "what": "kernel launches of the phase's validation and serving "
                                    "(fp32 and bf16, batch 1-2; the eager comparison apart), "
                                    "not in the kernels line",
          "launches": dict(total), "gpu": gpu})
    grad_check(gpu)


# ---------------------------------------------------------------- distillation

# (a) flagship_bf16_tpu.yml at its published widths, 224 px, batch 4: two
# phases of DISTILL_STEPS steps each, cut in depth only
DISTILL_CONFIG, DISTILL_PHASES, DISTILL_STEPS, DISTILL_WARMUP = "drift_bf16", (50, 25), 4, 2
DISTILL_RES, DISTILL_BATCH, DISTILL_EMB = 224, 4, 512
# per distill step the teacher runs two dual-net predictions on the drift
# path's kernels: twice a sampler step's launches
DISTILL_PER_STEP = {k: 2 * n for k, n in PATHS["drift"].items()}
# (b) the gate's recipe (JAX's tests/conftest.py:train_tiny_engine and
# tests/test_distill.py): the teacher 300 steps of batch 8 on 16 OCT
# phantoms, then one phase T=16 -> 8 of 150 steps at lr 1e-3, raw teacher,
# batches of 8 from default_rng(50_000 + i); scored on the first 4 images
GATE_TEACHER_STEPS, GATE_PHASE_STEPS, GATE_LR, GATE_STUDENT = 300, 150, 1e-3, 8
# (demo_all_modalities runs in a process of its own beside the rest of the
# phase, within DEMO_TIMEOUT seconds)
DEMO_TIMEOUT = 900
# demo_all_modalities cut from its 800 steps to 500: a tiny train step is
# host-bound (~0.2 s on the card) and the phase's time is the script's; at
# 400 steps low-dose CT cleared its +6 dB by 0.7 dB only
DEMO_STEPS = 500
GATE_MIN_GAIN_DB, GATE_MAX_GAP_DB = 6.0, 1.0
# the flash kernel at every head width it takes, at the bottleneck's N
FLASH_WIDTH_N = 1024


def flash_widths(gpu) -> None:
    """The flash kernel at every head width and dtype (fp32, bf16, fp16)
    against its plain version, timed with its bound and SDPA's time, at
    [8, 4, 1024, D]; which kernel the plan picks."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    for D in HEAD_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            shape = (BATCH, 4, FLASH_WIDTH_N, D)
            m = measure_flash(shape, dtype, gen)
            emit({"phase": "check", "what": "flash at every head width", "shape": shape,
                  "dtype": str(dtype), "path": flash_plan(D, dtype)["path"],
                  "warps": flash_plan(D, dtype, FLASH_WIDTH_N)["warps"], "tol": TOL[dtype],
                  **m, "gpu": gpu})


@contextlib.contextmanager
def timed_distill_steps():
    """While open, every ``distill_step`` the phases run is timed with the
    device drained before and after, the kernels it launched counted, the
    teacher's two predictions timed with CUDA events around them, and peak
    memory read (reset when a phase begins); yields {student steps: [step
    records]}."""
    from instancediff_torch.models import distill as distill_mod

    real_step, real_dual = distill_mod.distill_step, CLIPDriftEngine._dual_forward
    rec, teacher_ms = {}, []

    def dual(self, *args, plain, **kwargs):
        if plain:
            return real_dual(self, *args, plain=plain, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_dual(self, *args, plain=plain, **kwargs)
        end.record()
        teacher_ms.append((start, end))
        return out

    def step(engine, teacher, batch, student_steps, *args, **kwargs):
        if student_steps not in rec:
            rec[student_steps] = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = read_launches()
        teacher_ms.clear()
        torch.cuda.synchronize()
        t = time.time()
        metrics = real_step(engine, teacher, batch, student_steps, *args, **kwargs)
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3
        after = read_launches()
        rec[student_steps].append({
            "ms": ms, "teacher_ms": sum(a.elapsed_time(b) for a, b in teacher_ms),
            "teacher_predictions": len(teacher_ms),
            "launches": {k: after[k] - before[k] for k in after}, "metrics": metrics,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
        return metrics

    with mock.patch.object(distill_mod, "distill_step", step), \
            mock.patch.object(CLIPDriftEngine, "_dual_forward", dual):
        yield rec


def distill_flagship(gpu, tmp) -> Counter:
    """(a) ``tools/distill`` at flagship_bf16_tpu.yml's widths (224 px,
    batch 4) on a seeded bundle: phases 50 and 25 of ``DISTILL_STEPS``
    steps; per phase the median ms per step after the warm-ups, the
    teacher's ms, launches per step (held to ``DISTILL_PER_STEP``), peak
    memory and the losses. Then on one batch the teacher's composed targets
    on the kernels against the plain path: an fp32 copy of the teacher held
    within ``TOL``, the bf16 teacher's error read and not held (a one-ulp
    difference at one conv flips bf16 roundings downstream, through both
    predictions and the step between them: 1.0-1.2 % of the largest target
    on the card, over the 1e-2 a single kernel call is held to);
    ``distill25`` served by
    ``Restorer.from_config`` at 25 steps, eta 0 (graph vs eager, launches
    per step), and the tool's student recaptured after one more distill
    step. Returns the phase's launches (the eager comparisons apart)."""
    from instancediff_torch.models.distill import Teacher, distill_step, distill_targets
    from instancediff_torch.tools import distill as distill_tool

    total = Counter()
    index = write_speckle_med(os.path.join(tmp, "data"), 2, DISTILL_RES, DISTILL_EMB,
                              ARTIFACT_PROMPTS)
    cfg = train_config(tmp, DISTILL_CONFIG, index, 2, 1, 10**6, 10**6)
    opt = load_options(cfg)
    models, out = os.path.join(tmp, "seeded"), os.path.join(tmp, "distilled")
    t0 = time.time()
    eng = create_model(opt["train"], opt["models"]["DriftNoise"], phase="train",
                       image_size=DISTILL_RES, device="cuda")
    for i, key in enumerate(("drift", "noise", "d_ema", "n_ema")):
        randomize_(eng.nets[key], seed=40 + i)
    randomize_(eng.text_encoder, seed=20)
    nbytes = eng.save(models, "seeded")
    del eng
    torch.cuda.empty_cache()
    zero_launches()
    t_tool = time.time()
    with timed_distill_steps() as rec:
        student = distill_tool.main(
            ["-opt", cfg, "--device", "cuda", "--ckpt-dir", models, "--ckpt-iter", "seeded",
             "--phases", *map(str, DISTILL_PHASES), "--steps-per-phase", str(DISTILL_STEPS),
             "--lr", "2e-5", "--out-dir", out])
    total.update(read_launches())
    tool_s = time.time() - t_tool
    for n, steps in rec.items():
        per_step = [r["launches"] for r in steps]
        if any({k: p[k] for k in DISTILL_PER_STEP} != DISTILL_PER_STEP for p in per_step) or \
                any(r["teacher_predictions"] != 2 for r in steps):
            raise AssertionError(f"distill phase {n}: launches per step {per_step}")
        last = steps[-1]["metrics"]
        if not all(np.isfinite(v) for r in steps for v in r["metrics"].values()):
            raise AssertionError(f"distill phase {n}: losses {[r['metrics'] for r in steps]}")
        timed = steps[DISTILL_WARMUP:]
        config_name = os.path.basename(TRAIN_CONFIGS[DISTILL_CONFIG])
        emit({"phase": "distill", "what": f"tools/distill {config_name}, {DISTILL_RES} px, "
                                          f"batch {DISTILL_BATCH}, bf16, phase -> {n} steps, "
                                          f"{DISTILL_STEPS} distill steps",
              "ms_per_step_median": statistics.median(r["ms"] for r in timed),
              "ms_per_step": [round(r["ms"], 3) for r in steps],
              "teacher_ms_median": statistics.median(r["teacher_ms"] for r in timed),
              "teacher_ms": [round(r["teacher_ms"], 3) for r in steps],
              "launches_per_step": per_step[-1], "expected_per_step": DISTILL_PER_STEP,
              "max_memory_allocated_gib": round(max(r["max_memory_allocated_gib"]
                                                    for r in steps), 3),
              "loss_first": steps[0]["metrics"], "loss_last": last, "gpu": gpu})
    emit({"phase": "distill", "what": "tools/distill end to end (seeded bundle saved, loaded, "
                                      "two phases, two bundles saved)",
          "seeded_bundle_bytes": nbytes, "seconds": round(time.time() - t0, 3),
          "tool_seconds": round(tool_s, 3), "bundles": sorted(
              f for f in os.listdir(out) if f.startswith("distill")), "gpu": gpu})

    # the teacher's targets on the kernels against the plain path, one batch
    rng = np.random.default_rng(8)
    shape = (DISTILL_BATCH, DISTILL_RES, DISTILL_RES, 1)
    batch = {"input": rng.uniform(-1, 1, shape).astype(np.float32),
             "target": rng.uniform(-1, 1, shape).astype(np.float32),
             "type_idx": np.arange(DISTILL_BATCH) % 5,
             "A_emb": rng.standard_normal((DISTILL_BATCH, 1, DISTILL_EMB)).astype(np.float32)}
    teacher = Teacher.from_engine(student, ema=False)
    fp32_teacher = Teacher.from_engine(student, ema=False)
    for net in (fp32_teacher.drift, fp32_teacher.noise):
        cast_compute_(net, torch.float32)
    gen = torch.Generator(device="cuda")
    errs = {}
    for dtype, t in ((torch.bfloat16, teacher), (torch.float32, fp32_teacher)):
        before = Counter(read_launches())
        got = distill_targets(student, t, batch, DISTILL_PHASES[-1], generator=gen.manual_seed(4))
        after = Counter(read_launches())
        after.subtract(before)
        if dict(after) != DISTILL_PER_STEP:
            raise AssertionError(f"teacher targets launched {dict(after)}")
        total.update(after)
        with contextlib.ExitStack() as stack:
            for patch in plain_kernels():
                stack.enter_context(patch)
            want = distill_targets(student, t, batch, DISTILL_PHASES[-1],
                                   generator=gen.manual_seed(4))
        for k in ("d_tgt", "n_tgt"):
            label = f"{str(dtype).split('.')[1]}_{k}"
            if dtype == torch.float32:
                errs[label + "_max_abs_err"] = check_err(
                    f"fp32 teacher {k}, kernels vs plain", got[k], want[k], dtype)
            else:
                errs[label + "_max_abs_err"] = (got[k] - want[k]).abs().max().item()
                errs[label + "_largest"] = want[k].abs().max().item()
        del got, want
    emit({"phase": "distill", "what": f"the teacher's composed targets ({DISTILL_RES} px, batch "
                                      f"{DISTILL_BATCH}) on the kernels against the plain path: "
                                      "the fp32 teacher held within TOL, the bf16 one read",
          **errs, "tol_fp32": TOL[torch.float32], "launches_per_teacher": DISTILL_PER_STEP,
          "gpu": gpu})
    del fp32_teacher

    # distill25 from its bundle through from_config on the compiled sampler
    n = DISTILL_PHASES[-1]
    r = Restorer.from_config(cfg, pth_dir=out, iteration=f"distill{n}",
                             batch_size=DISTILL_BATCH, sample_steps=n, eta=0.0, use_ema=False,
                             device="cuda", seed=0)
    before = Counter(read_launches())
    t = time.time()
    served = r.restore(batch["input"], [ARTIFACT_PROMPTS[i] for i in batch["type_idx"]])
    torch.cuda.synchronize()
    served_s = time.time() - t
    graph = r.engine.last_graph
    after = Counter(read_launches())
    after.subtract(before)
    total.update(after)
    per_step = {k: graph.launches[NAMES[k]] for k in PATHS["drift"]}
    want = r.engine.test({"input": batch["input"], "type_idx": batch["type_idx"]},
                         torch.Generator(device="cuda").manual_seed(0), use_ema=False,
                         sample_steps=n, eta=0.0, compiled=False)
    vs_eager = check_graph_vs_eager(f"distill{n}", served, want.cpu().numpy(), torch.bfloat16)
    if per_step != PATHS["drift"] or r.engine.captures != 1 or graph.replays != n \
            or not vs_eager["bit_identical"]:
        raise AssertionError(f"distill{n} served: launches per step {per_step}, captures "
                             f"{r.engine.captures}, replays {graph.replays}, {vs_eager}")
    emit({"phase": "distill", "what": f"the distill{n} bundle through Restorer.from_config, "
                                      f"{n} steps, eta 0, bf16, {DISTILL_BATCH} images, "
                                      "compiled sampler",
          **vs_eager, "launches_per_step": per_step, "captures": r.engine.captures,
          "request_s_with_capture": round(served_s, 3), "gpu": gpu})
    del r, served, want

    # the tool's student: served, one more distill step, served again
    sample = {"input": batch["input"], "type_idx": batch["type_idx"]}

    def serve_student(compiled=None):
        return student.test(sample, torch.Generator(device="cuda").manual_seed(1),
                            use_ema=False, sample_steps=n, eta=0.0, compiled=compiled)

    before = Counter(read_launches())
    serve_student()
    captures = student.captures
    distill_step(student, teacher, batch, n, generator=gen.manual_seed(6), lr=2e-5)
    got = serve_student()
    after = Counter(read_launches())
    after.subtract(before)
    total.update(after)
    want = serve_student(compiled=False)
    if student.captures != captures + 1:
        raise AssertionError("no new capture after a distill step updated the student")
    emit({"phase": "distill", "what": f"the tool's student at {n} steps, eta 0, before and "
                                      "after one more distill step: recaptured, graph vs eager",
          **check_graph_vs_eager("student after a distill step", got, want, torch.bfloat16),
          "captures_before": captures, "captures_after": student.captures, "gpu": gpu})
    del student, teacher, got, want
    torch.cuda.empty_cache()
    return total


def gate_config(tmp, root) -> str:
    """``tiny_cpu.yml`` as the gate's engine (nf 16, score-map ngf 16, T=16,
    max_sigma 0.3, all five artifact types) with its test split the set at
    ``root``: the config ``eval_protocol`` scores the gate's bundles with."""
    with open("Configurations/tiny_cpu.yml") as f:
        opt = yaml.safe_load(f)
    net = dict(opt["models"]["DriftNoise"]["nnet_settings"], nf=16)
    opt["models"]["DriftNoise"].update(nnet_settings=net, dnet_settings=net, score_map_ngf=16,
                                       drift_net_lr=2e-3, noise_net_lr=2e-3)
    opt["sdes"]["driftSDE"].update(T=16, max_sigma=0.3)
    opt.pop("type_map_ind")
    opt["artifact_type"] = list(ARTIFACT_PROMPTS)
    opt["datasets"] = {"test": dict(name="test_dataset", mode="SpeckleMed", resolution=32,
                                    emb_dim=16, dataset_file=os.path.join(root, "dataset_file.json"),
                                    use_artifact_type=list(ARTIFACT_PROMPTS))}
    opt["test"].update(pth_dir=os.path.join(tmp, "gate_models"), batch_size=5,
                       result_dir=os.path.join(tmp, "results"), use_ema=False)
    path = os.path.join(tmp, "gate.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


DEMO_SCRIPT = """import json, sys
from instancediff_torch.models.engine import kernel_launches
from instancediff_torch.tools import demo_all_modalities
out = demo_all_modalities.main(sys.argv[1:])
print(json.dumps({"per_modality": out, "launches": kernel_launches("launches")}))
"""


def start_demo(tmp) -> tuple:
    """``demo_all_modalities`` (``DEMO_STEPS`` steps on the card) started in a
    process of its own: a tiny net's train step is host-bound, so it runs
    beside other work (phases ``irsde`` and ``dist``). Returns (process,
    start time)."""
    script = os.path.join(tmp, "demo_all_modalities_json.py")
    with open(script, "w") as f:
        f.write(DEMO_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    demo_dir = os.path.join(tmp, "demo")
    os.makedirs(demo_dir)
    proc = start_logged([sys.executable, script, "--device", "cuda", "--steps",
                         str(DEMO_STEPS)], demo_dir, env)
    return proc, time.time()


def finish_demo(gpu, started) -> Counter:
    """Wait for ``start_demo``'s process; each modality restored >= degraded
    + ``GATE_MIN_GAIN_DB``. Returns its kernel launches."""
    proc, t0 = started
    out, err = finish_logged(proc, DEMO_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"demo_all_modalities rc {proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    result = json.loads(out.strip().splitlines()[-1])
    demo = result["per_modality"]
    short = {m: s for m, s in demo.items()
             if not s["restored"]["PSNR"] >= s["degraded"]["PSNR"] + GATE_MIN_GAIN_DB}
    launches = {k: result["launches"][name] for k, name in NAMES.items()}
    emit({"phase": "distill", "what": "demo_all_modalities on the card: one nf 16 model, all "
                                      f"five modalities, {DEMO_STEPS} steps of batch 10, T=16, "
                                      "eta 1 (a process of its own, beside phases irsde and "
                                      "dist); its launches not in the kernels line",
          "per_modality": demo, "launches": launches, "seconds": round(time.time() - t0, 3),
          "gpu": gpu})
    if short:
        raise AssertionError(f"demo: restored < degraded + {GATE_MIN_GAIN_DB} dB for {short}")
    return Counter(launches)


def distill_gate(gpu, tmp) -> Counter:
    """(b) JAX's distillation gate on weights that learned, fp32 at nf 16,
    ch_mult [1, 2] (8-wide bottleneck heads): the gate's teacher
    trained with the recipe of JAX's fixture, one ``distill_phase`` to T=8,
    the student >= degraded + 6 dB and within 1 dB of the teacher; then a
    port Synthetic set (32 px, 2 test images per type) with its manifest,
    scored by ``eval_protocol`` for the teacher and the student. Returns
    the phase's launches."""
    from instancediff_torch.models.distill import distill_phase
    from instancediff_torch.tools import eval_protocol, make_synth_dataset
    from instancediff_torch.tools.demo_restoration import (restore_and_score,
                                                           synthetic_arrays, tiny_engine, train)

    total = Counter()
    zero_launches()
    t0 = time.time()
    data = synthetic_arrays(16, ["speckle in OCT"])
    eng = tiny_engine("cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        loss = train(eng, data, GATE_TEACHER_STEPS, 8, 1000, 0)
    train_s = time.time() - t0

    def mean_psnr(scores, which):
        return float(np.mean([s[which]["PSNR"] for s in scores]))

    teacher_scores = restore_and_score(eng, data, 4)
    models = os.path.join(tmp, "gate_models")
    eng.save(models, "teacher")

    def batches():
        i = 0
        while True:
            idx = np.random.default_rng(50_000 + i).choice(16, 8, replace=False)
            yield {k: v[idx] for k, v in data.items()}
            i += 1

    t0 = time.time()
    distill_phase(eng, GATE_STUDENT, batches(), GATE_PHASE_STEPS, lr=GATE_LR,
                  ema_as_teacher=False, log_every=0,
                  generator=torch.Generator(device="cuda").manual_seed(77))
    torch.cuda.synchronize()
    phase_s = time.time() - t0
    student_scores = restore_and_score(eng, data, 4, sample_steps=GATE_STUDENT, eta=0.0)
    eng.save(models, f"distill{GATE_STUDENT}")
    degraded = mean_psnr(teacher_scores, "degraded")
    p_teacher, p_student = mean_psnr(teacher_scores, "restored"), mean_psnr(student_scores,
                                                                          "restored")
    gate = {"degraded_psnr": degraded, "teacher_T16_eta1_psnr": p_teacher,
            f"student_T{GATE_STUDENT}_eta0_psnr": p_student,
            "student_gain_db": p_student - degraded, "teacher_minus_student_db": p_teacher - p_student}
    emit({"phase": "distill", "what": "the distillation gate: teacher (JAX's fixture recipe, "
                                      f"{GATE_TEACHER_STEPS} steps) -> one phase T=16 -> "
                                      f"{GATE_STUDENT}, {GATE_PHASE_STEPS} steps, lr {GATE_LR}, "
                                      "raw teacher; mean over the first 4 images",
          **gate, "teacher_last_loss": loss, "teacher_train_s": round(train_s, 3),
          "phase_s": round(phase_s, 3), "ms_per_distill_step": round(
              phase_s * 1e3 / GATE_PHASE_STEPS, 3), "teacher_scores": teacher_scores,
          "student_scores": student_scores, "gpu": gpu})
    if not (p_student >= degraded + GATE_MIN_GAIN_DB and p_teacher - p_student <= GATE_MAX_GAP_DB):
        raise AssertionError(f"distillation gate failed: {gate}")
    del eng
    total.update(read_launches())

    # the pinned-manifest protocol over a port Synthetic set
    root = os.path.join(tmp, "gate_set")
    with contextlib.redirect_stdout(io.StringIO()):
        make_synth_dataset.main(["--root", root, "--res", "32", "--n-train", "0", "--n-val",
                                 "0", "--n-test", "10", "--emb-dim", "16"])
    cfg = gate_config(tmp, root)
    zero_launches()
    tables = {}
    for tag, extra in (("teacher", ["--iter", "teacher"]),
                       (f"student{GATE_STUDENT}", ["--iter", f"distill{GATE_STUDENT}",
                                                   "--sample-steps", str(GATE_STUDENT),
                                                   "--eta", "0"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            record = eval_protocol.main(["--opt", cfg, "--dataset-root", root, "--tag", tag,
                                         "--device", "cuda", "--use-ema", "0", "--out-dir",
                                         os.path.join(tmp, "eval"), *extra])
        tables[tag] = record["table"]
        print("\n".join(ln for ln in buf.getvalue().splitlines() if ln.startswith("|")),
              flush=True)
    total.update(read_launches())
    emit({"phase": "distill", "what": "eval_protocol on a port Synthetic set (32 px, 2 test "
                                      "images per type, manifest verified) for the gate's "
                                      "teacher (T=16, eta 1) and student (T=8, eta 0)",
          "manifest_sha256": record["manifest_sha256"], "tables": tables, "gpu": gpu})
    return total


GATE_SCRIPT = """import json, os, sys
import chip_smoke
os.chdir(chip_smoke.ROOT)  # the gate's configs are read from the repository
launches = chip_smoke.distill_gate(sys.argv[1], sys.argv[2])
print(json.dumps({"gate_launches": dict(launches)}))
"""


def start_gate(gpu, tmp) -> tuple:
    """``distill_gate`` (b) started in a process of its own: a tiny net's
    train steps are host-bound, so it runs beside phase ``train``. Returns
    (process, start time)."""
    script = os.path.join(tmp, "distill_gate.py")
    with open(script, "w") as f:
        f.write(GATE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    gate_dir = os.path.join(tmp, "gate")
    os.makedirs(gate_dir)
    return start_logged([sys.executable, script, gpu, gate_dir], gate_dir, env), time.time()


def finish_gate(started) -> Counter:
    """Wait for ``start_gate``'s process, print its phase lines; returns its
    kernel launches."""
    proc, t0 = started
    out, err = finish_logged(proc, DEMO_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"the distillation gate rc {proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    *lines, last = out.strip().splitlines()
    for line in lines:
        print(line, flush=True)
    emit({"phase": "distill", "what": "the gate's process (beside phase train)",
          "seconds": round(time.time() - t0, 3)})
    return Counter(json.loads(last)["gate_launches"])


def distill_phase_chip(gpu, gate) -> None:
    """Phase ``distill``: (a) at flagship width, and (b) the gate, which
    ``start_gate`` started beside phase ``train``; its launches in a line of
    its own. (b)'s demo runs later, beside phases ``irsde`` and ``dist``
    (``start_demo``, ``finish_demo``)."""
    t0 = time.time()
    total = Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_distill_") as tmp:
        total.update(distill_flagship(gpu, tmp))
    total.update(finish_gate(gate))
    if not all(total[k] for k in ("conv", "flash", "affine")):
        raise AssertionError(f"the distill phase launched {dict(total)}")
    emit({"phase": "distill", "what": "kernel launches of the phase (the teachers' rollouts, "
                                      "the students' sampling, eval_protocol; the eager "
                                      "comparisons apart), not in the kernels line",
          "launches": dict(total), "seconds": round(time.time() - t0, 3), "gpu": gpu})


# ---------------------------------------------------------------- data parallel

ROOT = os.path.dirname(os.path.abspath(__file__))
# (a) trainUM launched by torch.distributed.run as one NCCL rank against the
# same run without a process group, flagship_bf16_tpu.yml's widths, 224 px,
# batch 4, cut in depth: DIST_ITERS iterations, one save (the end's), one
# validation (rank 0, at the last iteration)
DIST_CONFIG, DIST_ITERS, DIST_LAUNCH_TIMEOUT = "drift_bf16", 2, 600
# (b) two ranks sharing the card over gloo, flagship_tpu.yml (fp32, remat),
# 224 px, global batch 4 (2 per rank): DIST_GLOO_STEPS steps on one set of
# injected draws, the first held to one process's step on the global batch
DIST_GLOO_CONFIG, DIST_GLOO_STEPS, DIST_WORLD_TIMEOUT = "drift_fp32", 2, 600
# both runs of (a) hold every op to a deterministic algorithm (cuDNN's
# default backward algorithms are not bit-repeatable), as phase train's
# resume runs do
DETERMINISTIC_TRAINUM = """import sys
import torch
torch.backends.cudnn.deterministic = True
from instancediff_torch.tools import trainUM
trainUM.main(sys.argv[1:])
"""


def start_trainum(root, cfg, dist: bool) -> tuple:
    """``tools/trainUM`` on ``cfg`` started in a process of its own from
    ``root``: with ``dist`` under ``python -m torch.distributed.run
    --nproc_per_node 1`` with ``--launcher pytorch`` (one NCCL rank), else
    plainly; returns (process, start time, dist)."""
    wrapper = os.path.join(root, "trainum_deterministic.py")
    with open(wrapper, "w") as f:
        f.write(DETERMINISTIC_TRAINUM)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, wrapper, "-opt", cfg]
    if dist:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
               "--master_addr", "127.0.0.1", "--master_port", str(parallel.free_port()),
               wrapper, "-opt", cfg, "--launcher", "pytorch"]
    return start_logged(cmd, root, env), time.time(), dist


def start_logged(cmd, cwd, env) -> subprocess.Popen:
    """``cmd`` started in the background, its standard output and error
    written to ``stdout.txt`` and ``stderr.txt`` in ``cwd`` (no pipe to fill)."""
    with open(os.path.join(cwd, "stdout.txt"), "w") as out, \
            open(os.path.join(cwd, "stderr.txt"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=err)
    proc.log_dir = cwd
    return proc


def finish_logged(proc, timeout) -> tuple:
    """Wait for a ``start_logged`` process; returns (standard output,
    standard error)."""
    proc.wait(timeout=timeout)
    with open(os.path.join(proc.log_dir, "stdout.txt")) as out, \
            open(os.path.join(proc.log_dir, "stderr.txt")) as err:
        return out.read(), err.read()


def finish_trainum(started) -> tuple:
    """Wait for ``start_trainum``'s process; returns (seconds, its standard
    output)."""
    proc, t0, dist = started
    out, err = finish_logged(proc, DIST_LAUNCH_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"trainUM ({'dist' if dist else 'plain'}) rc {proc.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    return time.time() - t0, out


def start_dist_launches(tmp) -> dict:
    """(a), started: trainUM with ``train.dist: true`` under
    ``torch.distributed.run`` (one NCCL rank) and the same run with
    ``train.dist: false``, both in the background (each mostly process
    start, engine build and a 2.3 GB save), beside the next phase."""
    index = write_speckle_med(os.path.join(tmp, "data"), 2, 224, 512, ARTIFACT_PROMPTS)
    started = {}
    for name, dist in (("dist", True), ("plain", False)):
        root = os.path.join(tmp, name)
        os.makedirs(root)
        cfg = train_config(root, DIST_CONFIG, index, DIST_ITERS, 1, 10**6, DIST_ITERS)
        with open(cfg) as f:
            opt = yaml.safe_load(f)
        opt["train"]["dist"] = dist
        with open(cfg, "w") as f:
            yaml.safe_dump(opt, f)
        started[name] = (start_trainum(root, cfg, dist),
                         os.path.join(root, "experiments", opt["name"]))
    return started


def stop_dist_launches(started) -> None:
    for (proc, _, _), _ in started.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dist_nccl_one_rank(gpu, started) -> None:
    """(a), finished: the bundle and ``{iter}.state`` the two runs of
    ``start_dist_launches`` wrote must hash alike."""
    hashes, seconds, logs = {}, {}, {}
    for name, (run, exp) in started.items():
        seconds[name], logs[name] = finish_trainum(run)
        hashes[name] = {f"{d}/{k}": v for d in ("models", "training_state")
                        for k, v in sha256_files(os.path.join(exp, d)).items()}
    if "world_size=1" not in logs["dist"] or f"VAL iter {DIST_ITERS}" not in logs["dist"]:
        raise AssertionError(f"the dist run's log:\n{logs['dist'][-3000:]}")
    if hashes["dist"] != hashes["plain"]:
        raise AssertionError(f"train.dist bundle and state differ from the plain run's: "
                             f"{hashes}")
    emit({"phase": "dist", "what": f"(a) trainUM {os.path.basename(TRAIN_CONFIGS[DIST_CONFIG])}"
                                   f", 224 px, batch 4, {DIST_ITERS} iterations, validated and "
                                   "saved at the end: train.dist under torch.distributed.run "
                                   "(one NCCL rank) against train.dist false, both cuDNN "
                                   "deterministic, run at once beside phase irsde",
          "files": len(hashes["dist"]), "sha256_identical": True,
          "seconds_dist_launch": round(seconds["dist"], 3),
          "seconds_plain": round(seconds["plain"], 3), "gpu": gpu})


def _rank_entry(fn, rank, world, port, queue, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        queue.put((rank, None, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the phase
        import traceback
        queue.put((rank, traceback.format_exc(), None))


def spawn_world(fn, world: int, *args, timeout: float = DIST_WORLD_TIMEOUT) -> list:
    """``fn(rank, *args)`` in ``world`` spawned processes joined by the
    launcher's environment on a free localhost port; the ranks' results in
    rank order (a rank's error as ``{"error": traceback}``). A world that
    does not finish within ``timeout`` is killed."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = parallel.free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, port, queue, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, err, out = queue.get(timeout=timeout)
            results[rank] = {"error": err} if err else out
    except queue_mod.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results.get(r, {"error": f"no result within {timeout} s"}) for r in range(world)]


def nccl_two_ranks_one_card(rank) -> dict:
    """One all-reduce over NCCL with both ranks on cuda:0."""
    import datetime

    parallel.init_distributed("cuda:0", backend="nccl", timeout=datetime.timedelta(seconds=60))
    try:
        t = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        return {"all_reduce": t.tolist()}
    finally:
        parallel.shutdown()


def gloo_draws() -> tuple:
    """The global batch and one set of injected draws for (b): per step t
    [4] and the standard noise [4, 224, 224, 1] (flagship_tpu.yml's engine
    degrades nothing on the device)."""
    rng = np.random.default_rng(60)
    images = rng.uniform(-1, 1, (4, 224, 224, 1)).astype(np.float32)
    data = {"input": images, "target": images[::-1].copy(), "type_idx": np.arange(4),
            "A_emb": rng.standard_normal((4, 1, 512)).astype(np.float32)}
    steps = load_options(TRAIN_CONFIGS[DIST_GLOO_CONFIG])["sdes"]["driftSDE"]["T"]
    draws = {"t": rng.integers(1, steps + 1, (DIST_GLOO_STEPS, 4)),
             "std_noise": rng.standard_normal((DIST_GLOO_STEPS, 4, 224, 224, 1)).astype(
                 np.float32)}
    return data, draws


def gloo_engine(device, seeded: bool):
    """A train engine of (b)'s config; with ``seeded`` its trained nets and
    text tower drawn from one numpy seed (``seeded_tree``, as ``grad_check``
    and the CPU goldens draw them: at its init conv2, conv_out and the
    attention out projections are zero, and the gradients behind them)."""
    torch.manual_seed(0)
    opt = load_options(TRAIN_CONFIGS[DIST_GLOO_CONFIG])
    eng = create_model(opt["train"], opt["models"]["DriftNoise"],
                       sde=create_sde(opt["sdes"]["driftSDE"]), image_size=224, remat=True,
                       device=device)
    if seeded:
        rng = np.random.default_rng(61)
        for key in eng.optimizers:
            load_flax_params(eng.nets[key], seeded_tree(flax_params(eng.nets[key]), rng))
        load_flax_params(eng.text_encoder, seeded_tree(flax_params(eng.text_encoder), rng))
    return eng


def gloo_rank(rank) -> dict:
    """(b) One rank of two sharing cuda:0 over gloo: rank 0's seeded weights
    broadcast to rank 1, its half of the global batch and of the draws, ``DIST_GLOO_STEPS`` steps, each timed, the
    gradient all-reduce timed; after step 1 rank 0 holds the averaged
    gradients and the updated parameters to one process's step on the
    global batch (``parity.check_grads``/``check_params``, the tolerances of
    ``grad_check``) while rank 1 waits; the ranks' parameters' digests after
    the last step."""
    import datetime

    dev = parallel.init_distributed("cuda:0", backend="gloo",
                                    timeout=datetime.timedelta(seconds=DIST_WORLD_TIMEOUT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    real_reduce = parallel.all_reduce_mean_
    reduces = []

    def timed_reduce(tensors, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.time()
        n = real_reduce(tensors, *args, **kwargs)
        torch.cuda.synchronize()
        reduces.append(((time.time() - t0) * 1e3, n))
        return n

    try:
        data, draws = gloo_draws()
        eng = gloo_engine(dev, seeded=rank == 0)  # rank 1 takes rank 0's by broadcast
        torch.cuda.synchronize()
        t0 = time.time()
        sent = parallel.broadcast_module_(eng.nets) + parallel.broadcast_module_(
            eng.text_encoder)
        torch.cuda.synchronize()
        out = {"broadcast_bytes": sent, "broadcast_ms": round((time.time() - t0) * 1e3, 3)}
        batch = parallel.shard_batch(data)
        half = slice(rank * 2, rank * 2 + 2)
        steps = []
        with mock.patch.object(parallel, "all_reduce_mean_", timed_reduce):
            for i in range(DIST_GLOO_STEPS):
                reduces.clear()
                torch.cuda.synchronize()
                t0 = time.time()
                eng.optimize_parameters(
                    batch, epoch=0, t=torch.tensor(draws["t"][i][half]),
                    std_noise=torch.tensor(draws["std_noise"][i][half]))
                torch.cuda.synchronize()
                grad_ms, grad_bytes = max(reduces, key=lambda r: r[1])
                steps.append({"ms": round((time.time() - t0) * 1e3, 3),
                              "all_reduce_ms": round(grad_ms, 3),
                              "all_reduce_bytes": grad_bytes})
                if i == 0 and rank == 0:
                    got = {k: {n: (p.grad.float().cpu().numpy(), p.detach().cpu().numpy())
                               for n, p in eng.nets[k].named_parameters()}
                           for k in eng.optimizers}
                    out["check"] = gloo_reference(eng, got, data, draws)
                if i == 0:
                    parallel.barrier()
        out["steps"] = steps
        digest = hashlib.sha256()
        for p in eng.nets.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        digests = [None, None]
        torch.distributed.all_gather_object(digests, digest.hexdigest())
        out["parameters_equal_over_ranks"] = digests[0] == digests[1]
        out["parameters"] = sum(p.numel() for k in eng.optimizers
                                for p in eng.nets[k].parameters())
        return out
    finally:
        parallel.shutdown()


def gloo_reference(eng, got, data, draws) -> dict:
    """One process's first step on the global batch (a fresh engine from
    the same seed; the process group hidden from the engine), against the
    2-rank step's averaged gradients and parameters ``got``."""
    ref = gloo_engine(eng.device, seeded=True)
    with mock.patch.object(parallel, "world_size", lambda: 1):
        ref.optimize_parameters(data, epoch=0, t=torch.tensor(draws["t"][0]),
                                std_noise=torch.tensor(draws["std_noise"][0]))
    read = {}
    for key in ref.optimizers:
        want = {n: (p.grad.float().cpu().numpy(), p.detach().cpu().numpy())
                for n, p in ref.nets[key].named_parameters()}
        g_w, p_w = ({n: v[i] for n, v in want.items()} for i in (0, 1))
        g_g, p_g = ({n: v[i] for n, v in got[key].items()} for i in (0, 1))
        what = f"2 ranks over gloo vs one process: {key} "
        tols, read[key + "_gradients"] = check_grads(g_g, g_w, GRAD_TOL, GRAD_FLOOR,
                                                     REDUCTION_TOL, what=what)
        n = sum(v.size for v in p_w.values())
        read[key + "_parameters"] = check_params(
            p_g, p_w, GRAD_TOL, [(ref.lr0[key], g_w, tols)], max(16, int(ADAM_SHARE * n)),
            what=what)
    read["loss_one_process"] = ref.loss_info["latest"]["l"]
    read["loss_two_ranks"] = eng.loss_info["latest"]["l"]
    lerr = abs(read["loss_two_ranks"] - read["loss_one_process"]) / abs(read["loss_one_process"])
    if lerr > GRAD_TOL:
        raise AssertionError(f"2-rank loss {read['loss_two_ranks']} vs one process "
                             f"{read['loss_one_process']}")
    del ref
    torch.cuda.empty_cache()
    return read


def dist_phase(gpu, started) -> None:
    """Phase ``dist``: (a) one NCCL rank through ``torch.distributed.run``,
    bit-identical to the run without a process group (``started`` by
    ``start_dist_launches``); (b) two ranks sharing the card over gloo
    against one process's step; NCCL's refusal of two ranks on one card."""
    t_phase = time.time()
    dist_nccl_one_rank(gpu, started)
    t0 = time.time()
    nccl = spawn_world(nccl_two_ranks_one_card, 2, timeout=120)
    emit({"phase": "dist", "what": "NCCL, two ranks on one card: one all-reduce",
          "refused": any("error" in r for r in nccl),
          "ranks": [r.get("error", "")[-400:] or r for r in nccl],
          "seconds": round(time.time() - t0, 3), "gpu": gpu})
    t0 = time.time()
    ranks = spawn_world(gloo_rank, 2)
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError("(b) gloo ranks failed:\n" + "\n".join(errors))
    if not all(r["parameters_equal_over_ranks"] for r in ranks):
        raise AssertionError("(b) the ranks' parameters differ after the steps")
    emit({"phase": "dist", "what": f"(b) two ranks sharing the card over gloo, "
                                   f"{os.path.basename(TRAIN_CONFIGS[DIST_GLOO_CONFIG])} (fp32, "
                                   "remat), 224 px, global batch 4 (2 per rank), TF32 off, "
                                   f"{DIST_GLOO_STEPS} steps; step 1 against one process's "
                                   "step on the global batch",
          "parameters": ranks[0]["parameters"],
          "ms_per_step_per_rank": [[s["ms"] for s in r["steps"]] for r in ranks],
          "all_reduce_ms_per_rank": [[s["all_reduce_ms"] for s in r["steps"]] for r in ranks],
          "all_reduce_bytes": ranks[0]["steps"][0]["all_reduce_bytes"],
          "broadcast_ms": [r["broadcast_ms"] for r in ranks],
          "broadcast_bytes": ranks[0]["broadcast_bytes"],
          "parameters_equal_over_ranks": True, **ranks[0]["check"],
          "tols": {"grad_of_leaf": GRAD_TOL, "floor_of_largest_leaf": GRAD_FLOOR,
                   "reductions_of_leaf": REDUCTION_TOL, "params_of_leaf": GRAD_TOL,
                   "adam_allowance_share": ADAM_SHARE},
          "seconds": round(time.time() - t0, 3), "gpu": gpu})
    emit({"phase": "dist", "what": "the phase", "seconds": round(time.time() - t_phase, 3),
          "gpu": gpu})


# ---------------------------------------------------------------- spatial

# the flagship drift sampler with the images' height split over two gloo
# ranks that share the card (``Restorer(spatial=2)``: halo exchanges,
# cross-shard GroupNorm statistics, the bottleneck's local queries against
# keys gathered from both ranks), eta 0, eagerly (a sharded call is not
# captured), against the same request unsharded on the same card: (what,
# dtype, engine knobs, px, steps)
SPATIAL_WORLD, SPATIAL_BATCH, SPATIAL_TIMEOUT = 2, 2, 900
SPATIAL_REQUESTS = (("fused body, fp32", torch.float32, None, 512, 2),
                    ("fused body, bf16", torch.bfloat16, None, 512, 2),
                    ("unfused body, fp32", torch.float32, {"fused_gnconv": False}, 256, 2))
# sharded vs unsharded: fp32 within SPATIAL_TOL_FP32 (abs); bf16 within
# ``TOL`` relative to the largest output, the bound phase ``parity`` holds
# kernels to against plain versions (``check_graph_vs_eager``)
SPATIAL_TOL_FP32 = 1e-4
# ``tools/restore --spatial 2``: flagship_tpu.yml's net (fp32) at 256 px, its
# weights seeded as ``flagship_engine``'s, 2 images, 2 steps, eta 0
SPATIAL_RESTORE = dict(config="Configurations/flagship_tpu.yml", res=256, images=2, steps=2)
# the sharded GroupNorm's two kernel entries: their wrappers, plain
# versions, sources, the TPU code they stand for, the nearest PyTorch call
SHARDED_NAMES = {"sums": "gn_partial_sums", "apply": "gn_apply"}
SHARDED_SOURCES = {
    "sums": ("instancediff_torch/csrc/group_norm_silu.cu",
             "instancediff_tpu/ops/pallas_kernels.py:279"),
    "apply": ("instancediff_torch/csrc/group_norm_silu.cu",
              "instancediff_tpu/ops/pallas_kernels.py:134")}
SHARDED_LIBRARY = {"sums": "torch.var_mean over (H, W): the nearest call (mean and variance "
                           "per channel, not the sums)",
                   "apply": "torch.addcmul(shift, x, scale): the nearest call (no SiLU)"}


def sharded_wrappers() -> dict:
    from instancediff_torch.ops import group_norm_silu as gns

    return {"sums": gns.gn_partial_sums, "apply": gns.gn_apply}


def all_launches() -> dict:
    """Every kernel wrapper's count, the sharded entries' too."""
    return {**read_launches(), **{k: w.launches for k, w in sharded_wrappers().items()}}


def zero_all_launches() -> None:
    zero_launches()
    for w in sharded_wrappers().values():
        w.launches = 0


def record_sharded_calls():
    """Patches that record the shapes the sharded path gives its kernels:
    (q, k) of each flash launch, x (and dtype) of each GroupNorm sums and
    apply launch; each records, then calls the wrapper itself."""
    from instancediff_torch.ops import group_norm_silu as gns

    seen = {"flash": Counter(), "sums": Counter(), "apply": Counter()}
    flash, sums, apply_ = flash_attention, gns.gn_partial_sums, gns.gn_apply

    def rec_flash(q, k, v):
        seen["flash"][(tuple(q.shape), tuple(k.shape))] += 1
        return flash(q, k, v)

    def rec_sums(x):
        seen["sums"][(tuple(x.shape), str(x.dtype))] += 1
        return sums(x)

    def rec_apply(x, scale, shift, silu=True):
        seen["apply"][(tuple(x.shape), str(x.dtype), bool(silu))] += 1
        return apply_(x, scale, shift, silu)

    patches = (mock.patch.object(unet_mod, "flash_attention", rec_flash),
               mock.patch.object(unet_mod, "gn_partial_sums", rec_sums),
               mock.patch.object(gns, "gn_partial_sums", rec_sums),
               mock.patch.object(gns, "gn_apply", rec_apply))
    return seen, patches


def sums_cost(shape, dtype):
    B, H, W, C = shape
    n = B * H * W * C
    # read x once, write sums [2, B, C] fp32; an add and a fused multiply-add
    # per element on the fp32 units
    return bound(n * (torch.finfo(dtype).bits // 8) + 2 * B * C * 4, 2.0 * n, torch.float32)


def apply_cost(shape, dtype, silu):
    B, H, W, C = shape
    n = B * H * W * C
    # read x once, write y once, scale and shift [2, B, C] fp32; a fused
    # multiply-add (and SiLU: exp, add, divide, multiply) per element
    return bound(2 * n * (torch.finfo(dtype).bits // 8) + 2 * B * C * 4,
                 (5 if silu else 1) * n, torch.float32)


def measure_sharded(kname, key, gen) -> dict:
    """The sums or apply kernel at one launch shape of the sharded path,
    against its plain version: max abs error, event ms, device ms, plain ms,
    the nearest library call's ms, the bound."""
    from instancediff_torch.ops import group_norm_silu as gns

    shape, dtype = key[0], getattr(torch, key[1].split(".")[-1])
    x = (0.5 + torch.randn(*shape, generator=gen, device=gen.device)).to(dtype)
    B, H, W, C = shape
    if kname == "sums":
        fn, plain = (lambda: gns.gn_partial_sums(x)), (lambda: gns.gn_partial_sums_plain(x))
        err = check_err(f"gn_partial_sums {shape} {dtype}", fn(), plain(), torch.float32)
        xf = x.float()
        library = lambda: torch.var_mean(xf, dim=(1, 2), correction=0)  # noqa: E731
        bound_ms, bound_by = sums_cost(shape, dtype)
    else:
        silu = key[2]
        scale = 1 + 0.2 * torch.randn(B, C, generator=gen, device=x.device)
        shift = 0.3 * torch.randn(B, C, generator=gen, device=x.device)
        fn = lambda: gns.gn_apply(x, scale, shift, silu)  # noqa: E731
        plain = lambda: gns.gn_apply_plain(x, scale, shift, silu)  # noqa: E731
        err = check_err(f"gn_apply {shape} {dtype}", fn(), plain(), dtype)
        s4, t4 = scale[:, None, None].to(dtype), shift[:, None, None].to(dtype)
        library = lambda: torch.addcmul(t4, x, s4)  # noqa: E731
        bound_ms, bound_by = apply_cost(shape, dtype, silu)
    return dict(max_abs_err=err, ms=cuda_ms(fn), device_ms=device_ms(fn, kname),
                plain_ms=cuda_ms(plain), library_ms=cuda_ms(library), bound_ms=bound_ms,
                bound_by=bound_by)


def spatial_restore_inputs(tmp, write: bool = True) -> list:
    """``SPATIAL_RESTORE``'s config (no bundle: the engine's own weights,
    which ``seeded_engines`` then seeds) and images, written under ``tmp``
    when ``write``; the ``tools/restore`` argv less ``--out`` and
    ``--spatial``."""
    cfg = os.path.join(tmp, "restore.yml")
    files = [os.path.join(tmp, f"scan{i}.npy") for i in range(SPATIAL_RESTORE["images"])]
    if write:
        opt = yaml.safe_load(open(SPATIAL_RESTORE["config"]))
        opt["resolution"] = SPATIAL_RESTORE["res"]
        opt["test"] = dict(opt.get("test") or {}, pth_dir=None, on_device_emb=False)
        with open(cfg, "w") as f:
            yaml.safe_dump(opt, f)
        rng = np.random.default_rng(42)
        res = SPATIAL_RESTORE["res"]
        for path in files:
            np.save(path, rng.uniform(-1, 1, (res, res)).astype(np.float32))
    types = [ARTIFACT_PROMPTS[0], ARTIFACT_PROMPTS[-1]][:len(files)]
    return ["-opt", cfg, "--images", *files, "--type", *types, "--pre-normalized",
            "--sample-steps", str(SPATIAL_RESTORE["steps"]), "--eta", "0"]


@contextlib.contextmanager
def seeded_engines():
    """While open, ``serving.engine_from_config`` seeds the engine it builds
    as ``flagship_engine`` seeds its own (the EMA nets, the text tower)."""
    from instancediff_torch import serving

    build = serving.engine_from_config

    def seeded(*args, **kwargs):
        eng = build(*args, **kwargs)
        for i, key in enumerate(("d_ema", "n_ema")):
            randomize_(eng.nets[key], seed=10 + i)
        randomize_(eng.text_encoder, seed=20)
        return eng

    with mock.patch.object(serving, "engine_from_config", seeded):
        yield


def spatial_rank(rank, restore_dir=None, device="cuda:0") -> dict:
    """One of ``SPATIAL_WORLD`` gloo ranks sharing the card: each request of
    ``SPATIAL_REQUESTS`` through ``Restorer(spatial=SPATIAL_WORLD)`` (the
    kernels' counts zeroed just before and read just after, the shapes the
    flash and the sharded GroupNorm kernels were given recorded); then rank 0
    alone serves the same request unsharded (``compiled=False``, the same
    seed) and holds the two apart, and, in this fresh process (torch.profiler
    still records the kernel libraries here), holds the sharded GroupNorm's
    two kernels against their plain versions at the recorded shapes. With
    ``restore_dir`` (``spatial_restore_inputs``): ``tools/restore --spatial
    SPATIAL_WORLD`` (rank 0 writes under ``restore_dir``/sharded), then on
    rank 0 the same command without ``--spatial`` (``restore_dir``/whole)."""
    import datetime

    dev = parallel.init_distributed(device, backend="gloo",
                                    timeout=datetime.timedelta(seconds=SPATIAL_TIMEOUT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // SPATIAL_WORLD))  # host cores shared
    try:
        out = {"requests": [], "shapes": {"sums": Counter(), "apply": Counter()}}
        for what, dtype, opts, res, steps in SPATIAL_REQUESTS:
            torch.manual_seed(0)  # the ranks' engines alike (``randomize_`` keeps biases' init)
            eng = flagship_engine(dtype, opts)
            restorer = Restorer(eng, batch_size=SPATIAL_BATCH, sample_steps=steps, eta=0.0,
                                seed=0, device=str(eng.device), spatial=SPATIAL_WORLD)
            rng = np.random.default_rng(40)
            images = rng.uniform(-1, 1, (SPATIAL_BATCH, res, res, 1)).astype(np.float32)
            types = [ARTIFACT_PROMPTS[i] for i in range(SPATIAL_BATCH)]
            seen, patches = record_sharded_calls()
            with contextlib.ExitStack() as stack:
                for patch in patches:
                    stack.enter_context(patch)
                zero_all_launches()
                torch.cuda.synchronize()
                t0 = time.time()
                got = restorer.restore(images, types)
                torch.cuda.synchronize()
                seconds = time.time() - t0
                launches = all_launches()
            req = {"what": what, "res": res, "steps": steps, "seconds": round(seconds, 3),
                   "launches": launches, "finite": bool(np.isfinite(got).all()),
                   "shape": list(got.shape),
                   "flash_q_k": [[list(q), list(k), n] for (q, k), n in seen["flash"].items()]}
            for k in ("sums", "apply"):
                out["shapes"][k].update(seen[k])
            if rank == 0:
                batch = {"input": images, "type_idx": np.array([eng.type_map[t] for t in types]),
                         "A_emb": np.zeros((SPATIAL_BATCH, 1, eng.context_dim), np.float32)}
                torch.cuda.synchronize()
                t0 = time.time()
                want = eng.test(batch, torch.Generator(device=dev).manual_seed(0),
                                sample_steps=steps, eta=0.0, compiled=False).float().cpu().numpy()
                torch.cuda.synchronize()
                req.update(unsharded_seconds=round(time.time() - t0, 3),
                           max_abs_err=float(np.abs(got - want).max()),
                           max_abs_unsharded=float(np.abs(want).max()))
                # the yardstick: the unsharded request on the plain versions
                with contextlib.ExitStack() as stack:
                    for patch in plain_kernels():
                        stack.enter_context(patch)
                    plain = eng.test(batch, torch.Generator(device=dev).manual_seed(0),
                                     sample_steps=steps, eta=0.0,
                                     compiled=False).float().cpu().numpy()
                req["unsharded_kernels_vs_plain"] = float(np.abs(want - plain).max())
            parallel.barrier()
            out["requests"].append(req)
            del eng, restorer
            torch.cuda.empty_cache()
        if restore_dir is not None:
            from instancediff_torch.tools import restore

            argv = spatial_restore_inputs(restore_dir, write=rank == 0)
            parallel.barrier()
            t0 = time.time()
            with seeded_engines():
                torch.manual_seed(0)  # what randomize_ keeps (biases' init) alike
                written = restore.main(argv + ["--spatial", str(SPATIAL_WORLD), "--out",
                                               os.path.join(restore_dir, "sharded")])
                out["restore"] = {"written": written, "seconds": round(time.time() - t0, 3)}
                parallel.barrier()
                if rank == 0:
                    torch.manual_seed(0)
                    t0 = time.time()
                    out["restore"].update(whole=restore.main(
                        argv + ["--out", os.path.join(restore_dir, "whole")]),
                        whole_seconds=round(time.time() - t0, 3))
        if rank == 0:
            gen = torch.Generator(device=dev).manual_seed(41)
            out["measured"] = {k: [(key, n, measure_sharded(k, key, gen))
                                   for key, n in out["shapes"][k].items()]
                               for k in ("sums", "apply")}
        parallel.barrier()
        out["shapes"] = {k: [[list(key), n] for key, n in v.items()]
                         for k, v in out["shapes"].items()}
        return out
    finally:
        parallel.shutdown()


def spatial_restore_check(ranks, gpu) -> None:
    """``tools/restore --spatial 2``: rank 0 alone wrote, one file per image,
    each within ``SPATIAL_TOL_FP32`` of the unsharded command's."""
    got = [r["restore"]["written"] for r in ranks]
    want = ranks[0]["restore"]["whole"]
    names = [os.path.basename(p) for p in want]
    if [os.path.basename(p) for p in got[0]] != names or any(got[1:]) \
            or len(names) != SPATIAL_RESTORE["images"]:
        raise AssertionError(f"tools/restore --spatial: wrote {got}, unsharded {want}")
    err = max(float(np.abs(np.fromfile(a, np.float32) - np.fromfile(b, np.float32)).max())
              for a, b in zip(got[0], want))
    if not err <= SPATIAL_TOL_FP32:
        raise AssertionError(f"tools/restore --spatial: {err} from the unsharded images")
    emit({"phase": "spatial", "what": f"tools/restore --spatial {SPATIAL_WORLD} over the gloo "
                                      f"ranks ({SPATIAL_RESTORE['config']}'s net, fp32, "
                                      f"{SPATIAL_RESTORE['res']} px, "
                                      f"{SPATIAL_RESTORE['images']} images, "
                                      f"{SPATIAL_RESTORE['steps']} steps, eta 0) against the "
                                      "same command unsharded",
          "files": names, "max_abs_err": err, "tol": SPATIAL_TOL_FP32,
          "seconds_per_rank": [r["restore"]["seconds"] for r in ranks],
          "unsharded_seconds": ranks[0]["restore"]["whole_seconds"], "gpu": gpu})


def spatial_phase(gpu) -> dict:
    """Phase ``spatial``: ``spatial_rank`` on ``SPATIAL_WORLD`` spawned
    ranks. Fails unless every request is finite, every rank launched the
    fused conv (fused body), the flash kernel with Nq = N / world against
    Nk = N, the sums kernel, and (unfused body) the apply kernel, and the
    sharded result is within the tolerance of the unsharded one. Returns the
    kernels line's entries of the two sharded GroupNorm kernels."""
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restore_") as restore_dir:
        ranks = spawn_world(spatial_rank, SPATIAL_WORLD, restore_dir, timeout=SPATIAL_TIMEOUT)
        errors = [r["error"] for r in ranks if "error" in r]
        if errors:
            raise AssertionError("spatial ranks failed:\n" + "\n".join(errors))
        spatial_restore_check(ranks, gpu)
    total = Counter()
    for i, (what, dtype, opts, res, steps) in enumerate(SPATIAL_REQUESTS):
        reqs = [r["requests"][i] for r in ranks]
        ref = reqs[0]
        tol = (SPATIAL_TOL_FP32 if dtype == torch.float32
               else TOL[dtype] * max(1.0, ref["max_abs_unsharded"]))
        need = ["flash", "sums"] + (["conv"] if opts is None else ["apply"])
        idle = [(r, k) for r, q in enumerate(reqs) for k in need if not q["launches"][k]]
        tokens = (res // 8) ** 2  # the bottleneck's
        nq_nk = {(q[0][2], q[1][2]) for r in reqs for q in r["flash_q_k"]}
        if (idle or not all(q["finite"] and q["shape"] == [SPATIAL_BATCH, res, res, 1]
                            for q in reqs)
                or nq_nk != {(tokens // SPATIAL_WORLD, tokens)}
                or not ref["max_abs_err"] <= tol):
            raise AssertionError(f"spatial, {what}: launched nothing of {idle}, flash Nq/Nk "
                                 f"{nq_nk}, sharded vs unsharded {ref['max_abs_err']} > {tol}: "
                                 f"{reqs}")
        emit({"phase": "spatial", "what": f"flagship drift sampler, {what}, {res} px, batch "
                                          f"{SPATIAL_BATCH}, {steps} steps, eta 0, the height "
                                          f"split over {SPATIAL_WORLD} gloo ranks sharing the "
                                          "card (Restorer spatial=2, eager), against the same "
                                          "request unsharded",
              "max_abs_err": ref["max_abs_err"], "tol": tol,
              "max_abs_unsharded": ref["max_abs_unsharded"],
              "unsharded_kernels_vs_plain": ref["unsharded_kernels_vs_plain"],
              "seconds_per_rank": [q["seconds"] for q in reqs],
              "unsharded_seconds": ref["unsharded_seconds"],
              "launches_per_rank": [q["launches"] for q in reqs],
              "flash_q_k_per_rank": [q["flash_q_k"] for q in reqs], "gpu": gpu})
        for q in reqs:
            total.update({k: v for k, v in q["launches"].items() if k in SHARDED_NAMES})
    entries = {}
    for kname, rows in ranks[0]["measured"].items():
        tot, bound_by = Counter(), Counter()
        for key, n, m in rows:
            for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += m[k] * n
            bound_by[m["bound_by"]] += m["bound_ms"] * n
            tot["max_abs_err"] = max(tot["max_abs_err"], m["max_abs_err"])
        emit({"phase": "spatial", "kernel": SHARDED_NAMES[kname],
              "what": "kernel vs plain at the sharded path's launch shapes (rank 0's, every "
                      "request), summed over those launches",
              "launches_measured": sum(n for _, n, _ in rows),
              **{k: round(v, 4) for k, v in tot.items()},
              "shapes_count_ms_device_plain_bound_library": [
                  [key, n, round(m["ms"], 4), round(m["device_ms"], 4),
                   round(m["plain_ms"], 4), round(m["bound_ms"], 4),
                   round(m["library_ms"], 4)] for key, n, m in rows], "gpu": gpu})
        entries[kname] = {
            "name": SHARDED_NAMES[kname], "route": "cuda", "source": SHARDED_SOURCES[kname][0],
            "replaces": SHARDED_SOURCES[kname][1], "launches": total[kname],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "device_ms": tot["device_ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": bound_by.most_common(1)[0][0], "library_ms": tot["library_ms"],
            "library": SHARDED_LIBRARY[kname],
            "per": "the sharded path's launches on rank 0, summed"}
    emit({"phase": "spatial", "what": "the phase", "seconds": round(time.time() - t_phase, 3),
          "gpu": gpu})
    return entries


# ---------------------------------------------------------------- FSDP

# ZeRO-style FSDP: two gloo ranks sharing the card on a 1 x 2 dp x fsdp
# grid, phase dist (b)'s config and seeded weights (flagship_tpu.yml: fp32,
# remat; 224 px), the whole batch of 4 on each rank, FSDP_STEPS steps on
# one set of injected draws, against one process's steps
FSDP_STEPS, FSDP_TIMEOUT = 2, 900


def fsdp_rank(rank, device="cuda:0") -> dict:
    """One rank of the 1 x 2 grid: the seeded engine sharded
    (``shard_fsdp``), the bytes of train state it holds against unsharded,
    ``FSDP_STEPS`` steps, each timed; the first moments after step 1 and the
    parameters after the last, gathered; rank 0 then takes the same steps in
    one process (the group hidden) and holds the loss and the first moments
    to them (``parity.check_grads``, the tolerances of ``grad_check``)."""
    import datetime

    from instancediff_torch.parallel.mesh import Grid

    dev = parallel.init_distributed(device, backend="gloo",
                                    timeout=datetime.timedelta(seconds=FSDP_TIMEOUT))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # host cores shared
    try:
        data, draws = gloo_draws()
        eng = gloo_engine(dev, seeded=True)
        eng.shard_fsdp(Grid(1, 2))
        out = {"bytes": eng.fsdp.held_bytes(), "steps": [], "losses": []}
        mu1 = None
        for i in range(FSDP_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            eng.optimize_parameters(data, epoch=0, t=torch.tensor(draws["t"][i]),
                                    std_noise=torch.tensor(draws["std_noise"][i]))
            torch.cuda.synchronize()
            out["steps"].append(round((time.time() - t0) * 1e3, 3))
            out["losses"].append(eng.loss_info["latest"]["l"])
            if i == 0:
                mu1 = {k: {n: v["exp_avg"].float().cpu().numpy().copy() for n, v in zip(
                    (n for n, _ in eng.nets[k].named_parameters()),
                    eng.fsdp.adam_view(k).state.values())} for k in eng.optimizers}
        out["bytes_after"] = eng.fsdp.held_bytes()
        if rank == 0:
            ref = gloo_engine(dev, seeded=True)
            losses = []
            with mock.patch.object(parallel, "world_size", lambda: 1):
                for i in range(FSDP_STEPS):
                    ref.optimize_parameters(data, epoch=0, t=torch.tensor(draws["t"][i]),
                                            std_noise=torch.tensor(draws["std_noise"][i]))
                    losses.append(ref.loss_info["latest"]["l"])
                    if i == 0:
                        want = {k: {n: ref.optimizers[k].state[p]["exp_avg"].float().cpu()
                                    .numpy().copy() for n, p in ref.nets[k].named_parameters()}
                                for k in ref.optimizers}
            out["losses_one_process"] = losses
            out["check"] = {k: check_grads(mu1[k], want[k], GRAD_TOL, GRAD_FLOOR,
                                           REDUCTION_TOL, what=f"FSDP {k} first moment ")[1]
                            for k in want}
            del ref
        parallel.barrier()
        return out
    finally:
        parallel.shutdown()


def fsdp_phase(gpu) -> None:
    """Phase ``fsdp``: ``fsdp_rank`` on two spawned ranks; fails unless
    every loss is within ``GRAD_TOL`` relative of one process's, the first
    moments pass ``check_grads``, and each rank holds less than 0.6 of the
    unsharded train state."""
    t0 = time.time()
    ranks = spawn_world(fsdp_rank, 2, timeout=FSDP_TIMEOUT)
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError("fsdp ranks failed:\n" + "\n".join(errors))
    r0 = ranks[0]
    lerr = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["losses_one_process"]))
    if not (lerr <= GRAD_TOL and all(r["losses"] == r0["losses"] for r in ranks)
            and all(r["bytes"]["held"] < 0.6 * r["bytes"]["unsharded"] for r in ranks)):
        raise AssertionError(f"fsdp: losses {[r['losses'] for r in ranks]} against one "
                             f"process's {r0['losses_one_process']}, bytes "
                             f"{[r['bytes'] for r in ranks]}")
    emit({"phase": "fsdp", "what": f"ZeRO-style FSDP, 1 x 2 dp x fsdp grid of gloo ranks "
                                   f"sharing the card, {os.path.basename(TRAIN_CONFIGS[DIST_GLOO_CONFIG])}"
                                   f" (fp32, remat), 224 px, batch 4, {FSDP_STEPS} steps, TF32 "
                                   "off, against one process's steps",
          "losses": r0["losses"], "losses_one_process": r0["losses_one_process"],
          "loss_max_rel_err": lerr, "first_moments": r0["check"],
          "bytes_held_per_rank": [r["bytes"] for r in ranks],
          "bytes_held_after_steps": [r["bytes_after"] for r in ranks],
          "ms_per_step_per_rank": [r["steps"] for r in ranks],
          "tols": {"loss_rel": GRAD_TOL, "grad_of_leaf": GRAD_TOL,
                   "floor_of_largest_leaf": GRAD_FLOOR, "reductions_of_leaf": REDUCTION_TOL},
          "seconds": round(time.time() - t0, 3), "gpu": gpu})


# ---------------------------------------------------------------- IR-SDE

# T cut from the configs' 100 for the script's time: the loops' depth, not
# their widths (each step is one full-width noise-net forward)
IRSDE_OPT = {"class_name": "IRSDE", "T": 12}
# per noise-net forward (one per sampler step / function evaluation): the
# DDPM net on the unfused body; the drift engine's noise net on the fused body
IRSDE_PATHS = {"ddpm": {"conv": 0, "flash": 1, "gn": 45, "affine": 0},
               "drift_noise": {"conv": 45, "flash": 1, "gn": 0, "affine": 45}}
# ode_sampler: fp32 at rtol = atol = IRSDE_ODE_RTOL, batch 8 at IRSDE_ODE_RES
# px (cut from 256 for the script's time; the widths are the paths'). The
# kernels' solve steps otherwise than the plain one (its roundoff moves error
# ratios across 1, and random weights drive x to O(100)), so it is another
# solve of the same ODE: held within IRSDE_ODE_TOL of the largest value plus
# twice the solve's own error (the kernels' solve's distance to theirs at
# rtol / 10)
IRSDE_ODE_RES, IRSDE_ODE_RTOL, IRSDE_ODE_TOL = 128, 1e-5, 1e-3


def irsde_noise_fn(eng, path, res):
    """``noise_fn(x, t)`` of ``path``'s noise net (the EMA copy) on the
    engine's call inputs for a seeded batch of ``BATCH`` at ``res`` px, and
    mu: the net sees (x, mu), its timestep t and the call's encodings."""
    rng = np.random.default_rng(70)
    batch = {"input": rng.uniform(-1, 1, (BATCH, res, res, 1)).astype(np.float32),
             "type_idx": np.arange(BATCH) % len(ARTIFACT_PROMPTS)}
    inputs = eng._inputs(batch, use_ema=True)
    mu, ty, img = inputs["mu"], inputs["type_idx"], inputs["img_ctx"]
    net = eng.nets["n_ema"]
    if path == "ddpm":
        text, extra = inputs["text"], ()
    else:
        text, extra = inputs["n_text"], (inputs["degra_ctx"],)

    def noise_fn(x, t):
        return net(x, mu, t, ty, text, img, *extra)[0]

    return noise_fn, mu


def irsde_loops(sde, noise_fn, mu, init, steps, plain: bool) -> dict:
    """reverse_sde (stochastic, injected noise) and reverse_ode at every
    step, on the kernels or the plain path: results, ms per step, launches."""
    out = {}
    with contextlib.ExitStack() as stack:
        for patch in plain_kernels() if plain else ():
            stack.enter_context(patch)
        for loop in ("reverse_sde", "reverse_ode"):
            kw = {"step_noise": steps} if loop == "reverse_sde" else {}
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            x = getattr(sde, loop)(mu, noise_fn, init_noise=init, **kw)
            torch.cuda.synchronize()
            out[loop] = (x, (time.time() - t0) * 1e3 / sde.T, read_launches())
    return out


def irsde_phase(gpu) -> Counter:
    """Phase ``irsde``: ``create_sde(IRSDE_OPT)`` (T=12)
    driven by two noise predictors at full width with seeded random weights
    (the DDPM net of flagship_ddpm_tpu.yml's widths, unfused body; the
    flagship drift engine's noise net, fused body), 256 px, batch 8, bf16:
    reverse_sde (stochastic, injected noise) and reverse_ode at all T
    steps on the kernels and on the plain path, held within ``TOL[bf16]``
    of the plain result's largest value, launches per step held to
    ``IRSDE_PATHS``, ms per step; then ``ode_sampler`` in fp32 (rtol = atol
    = ``IRSDE_ODE_RTOL``) at ``IRSDE_ODE_RES`` px on both paths, and on the
    kernels at a tenth of the tolerance (the solve's own error): function
    evaluations, accepted and rejected steps, launches per evaluation.
    Returns the kernels' launches (the kernels line's)."""
    t_phase = time.time()
    total = Counter()
    sde = create_sde(dict(IRSDE_OPT))
    gen = torch.Generator(device="cuda").manual_seed(71)
    with torch.inference_mode():
        for path, make in (("ddpm", ddpm_engine), ("drift_noise", flagship_engine)):
            per_fwd = IRSDE_PATHS[path]
            eng = make(torch.bfloat16)
            noise_fn, mu = irsde_noise_fn(eng, path, RES)
            init = torch.randn(mu.shape, generator=gen, device="cuda")
            steps = list(torch.randn((sde.T,) + tuple(mu.shape), generator=gen, device="cuda"))
            k = irsde_loops(sde, noise_fn, mu, init, steps, plain=False)
            p = irsde_loops(sde, noise_fn, mu, init, steps, plain=True)
            for loop in ("reverse_sde", "reverse_ode"):
                (xk, ms_k, nk), (xp, ms_p, npl) = k[loop], p[loop]
                per_step = {kk: v / sde.T for kk, v in nk.items()}
                if per_step != per_fwd or any(npl.values()):
                    raise AssertionError(f"IR-SDE {path} {loop}: launches {nk} (plain {npl})")
                total.update(nk)
                err = (xk - xp).abs().max().item()
                limit = TOL[torch.bfloat16] * max(1.0, xp.abs().max().item())
                if not (err <= limit and torch.isfinite(xk).all()):
                    raise AssertionError(f"IR-SDE {path} {loop}: kernels vs plain {err} > {limit}")
                emit({"phase": "irsde", "what": f"{loop}, {path} noise net, bf16, {RES} px, "
                                                f"batch {BATCH}, {sde.T} steps, kernels vs plain",
                      "launches_per_step": per_step, "ms_per_step_kernels": round(ms_k, 3),
                      "ms_per_step_plain": round(ms_p, 3), "max_abs_err": err, "tol": limit,
                      "max_abs_plain": xp.abs().max().item(), "gpu": gpu})
            del eng, k, p, steps
            torch.cuda.empty_cache()

            eng = make(torch.float32)
            noise_fn, mu = irsde_noise_fn(eng, path, IRSDE_ODE_RES)
            x_T = mu + sde.max_sigma * torch.randn(mu.shape, generator=gen, device="cuda")
            res = {}
            for plain, rtol in ((False, IRSDE_ODE_RTOL), (True, IRSDE_ODE_RTOL),
                                (False, IRSDE_ODE_RTOL / 10)):
                with contextlib.ExitStack() as stack:
                    for patch in plain_kernels() if plain else ():
                        stack.enter_context(patch)
                    zero_launches()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    x, info = sde.ode_sampler(x_T, mu, noise_fn, rtol=rtol, atol=rtol,
                                              return_info=True)
                    torch.cuda.synchronize()
                    res[plain, rtol] = (x, info, time.time() - t0, read_launches())
            (xk, ik, sk, nk), (xp, ip, sp, npl) = (res[False, IRSDE_ODE_RTOL],
                                                   res[True, IRSDE_ODE_RTOL])
            if {kk: v / ik["nfev"] for kk, v in nk.items()} != per_fwd or any(npl.values()):
                raise AssertionError(f"IR-SDE ode_sampler {path}: launches {nk} for {ik}")
            total.update(nk)
            err = (xk - xp).abs().max().item()
            # the solve's own error: the kernels' solve against theirs at rtol / 10
            ref = res[False, IRSDE_ODE_RTOL / 10]
            total.update(ref[3])
            own = (xk - ref[0]).abs().max().item()
            limit = IRSDE_ODE_TOL * max(1.0, xp.abs().max().item()) + 2 * own
            if not (err <= limit and torch.isfinite(xk).all()):
                raise AssertionError(f"IR-SDE ode_sampler {path}: kernels vs plain {err} > {limit}")
            emit({"phase": "irsde", "what": f"ode_sampler, {path} noise net, fp32, "
                                            f"{IRSDE_ODE_RES} px, batch {BATCH}, rtol = atol = "
                                            f"{IRSDE_ODE_RTOL}, kernels vs plain",
                  "kernels": {**ik, "seconds": round(sk, 3)},
                  "plain": {**ip, "seconds": round(sp, 3)},
                  "launches_per_evaluation": {kk: v / ik["nfev"] for kk, v in nk.items()},
                  "kernels_at_rtol_over_10": ref[1],
                  "ms_per_evaluation_kernels": round(sk * 1e3 / ik["nfev"], 3),
                  "max_abs_err": err, "solve_own_error": own, "tol": limit,
                  "max_abs_plain": xp.abs().max().item(),
                  "gpu": gpu})
            del eng, res
            torch.cuda.empty_cache()
    emit({"phase": "irsde", "what": "the phase: kernel launches (in the kernels line)",
          "launches": dict(total), "seconds": round(time.time() - t_phase, 3), "gpu": gpu})
    return total


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


def sweep_conv_fp32(gpu) -> None:
    """Time the fp32 (split-TF32) conv kernel at each flagship launch shape
    and the 224 px decoder's 28x28 (batch 8) under each N block near its
    plan's, beside cuDNN's fp32 conv (TF32 off) on the normalised input;
    one JSON line per shape (ms, median of 10)."""
    # imported here: the module-level imports also serve fp32_request_ab on
    # a tree from before this packing
    from instancediff_torch.ops.fused_gn_conv import pack_weights_tf32x3

    lib = _build.load("fused_gn_silu_conv3x3")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for H, W, C, Cout in SWEEP_SHAPES + [(28, 28, 528, 256)]:
        shape = (BATCH, H, W, C, Cout, False)
        x, scale, shift, w, bias, _ = conv_case(shape, torch.float32, gen)
        out = torch.empty(BATCH, H, W, Cout, device="cuda")
        want = fused_gn_silu_conv3x3_plain(x, scale, shift, w, bias)
        xn = torch.nn.functional.silu(
            x * scale[:, None, None] + shift[:, None, None]).permute(0, 3, 1, 2)
        wk = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        plan = conv_plan(BATCH, H, W, C, Cout, torch.float32)
        row = {"phase": "sweep", "dtype": "float32", "shape": [BATCH, H, W, C, Cout],
               "plan": f"{plan['th']}x{plan['tw']} nb{plan['nb']}",
               "cudnn_ms": cuda_ms(lambda: torch.nn.functional.conv2d(xn, wk, padding=1))}
        for nb in ((8, 16) if Cout <= 8 else (32, 64, 128)):
            if nb > max(32, Cout):
                continue
            wpk = pack_weights_tf32x3(w, nb)

            def run():
                _build.check(lib.fgc_tf32_forward(
                    x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wpk.data_ptr(),
                    bias.data_ptr(), None, out.data_ptr(), BATCH, H, W, C, Cout, nb,
                    torch.cuda.current_stream().cuda_stream), "sweep")

            run()
            check_err(f"sweep {row['shape']} fp32 nb{nb}", out, want, torch.float32)
            row[f"8x16 nb{nb}"] = cuda_ms(run)
        emit(dict(row, gpu=gpu))


def sweep_flash(gpu) -> None:
    """Time the fp32 (split-TF32) flash kernel with 4 and with 8 warps per
    block at [8, 4, 1024, D] for every head width and at the image tower's
    and the 224 px bottleneck's shapes, beside SDPA; one JSON line per shape
    (ms: events around one call, and per call over 20 back-to-back calls,
    medians of 10)."""
    lib = _build.load("flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = [(BATCH, 4, FLASH_WIDTH_N, D) for D in HEAD_WIDTHS] + [
        (BATCH, 12, 197, 64), (BATCH, 12, 257, 64), (BATCH, 4, 784, 64)]
    for shape in shapes:
        B, Hh, N, D = shape
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda") for _ in range(3))
        out = torch.empty_like(q)
        want = flash_attention_plain(q, k, v)

        def back_to_back(fn, n=20):
            def run():
                for _ in range(n):
                    fn()
            return cuda_ms(run) / n

        row = {"phase": "sweep", "dtype": "float32", "shape": list(shape),
               "plan_warps": flash_plan(D, torch.float32, N)["warps"],
               "sdpa_ms": [cuda_ms(lambda: sdpa(q, k, v)), back_to_back(lambda: sdpa(q, k, v))]}
        for warps in (4, 8):
            def run():
                _build.check(lib.flash_forward(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * Hh, N, N, D,
                    D ** -0.5, 0, 2, warps, torch.cuda.current_stream().cuda_stream), "sweep")

            run()
            check_err(f"sweep flash {shape} {warps} warps", out, want, torch.float32)
            row[f"warps{warps}_ms"] = [cuda_ms(run), back_to_back(run)]
        emit(dict(row, gpu=gpu))


def fp32_request_ab(roots) -> int:
    """``fp32_request`` on the package of each tree in ``roots`` in turn (a
    directory holding an ``instancediff_torch`` and ``Configurations``, e.g.
    an unpacked parent commit, and "." for this one), each in a process of
    its own that builds that tree's kernels; this file's request code runs
    on each. Prints each run's lines with its root; returns 1 if one failed."""
    code = (f"import importlib.util, os, sys\nsys.path.insert(0, '.')\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke_ab', "
            f"{os.path.abspath(__file__)!r})\n"
            "cs = importlib.util.module_from_spec(spec)\nspec.loader.exec_module(cs)\n"
            "assert cs._build.__file__.startswith(os.getcwd() + os.sep), cs._build.__file__\n"
            "cs._build.build_all()\n"
            "for n in cs._build.SIGNATURES:\n    cs._build.load(n)\n"
            "cs.torch.backends.cudnn.allow_tf32 = False\n"
            "cs.torch.backends.cuda.matmul.allow_tf32 = False\n"
            "cs.fp32_request(cs.gpu_name_and_power())\n")
    rc = 0
    for root in roots:
        t0 = time.time()
        p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
        for ln in p.stdout.splitlines():
            if ln.startswith("{"):
                emit(dict(json.loads(ln), root=root))
        emit({"phase": "fp32_request_ab", "root": root, "rc": p.returncode,
              "seconds": round(time.time() - t0, 1)})
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr, flush=True)
            rc = 1
    return rc


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
            row[name] = [cuda_ms(run), device_ms(run, "gn", per_call=GN_LAUNCHES[name])]

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


def per_forward(shapes, gen, worst, gpu) -> dict:
    """Phase ``per_forward``: every kernel of every path held against its
    plain version and timed at that path's own launch shapes (``shapes``,
    from ``record_launch_shapes``), summed over one UNet forward; one line
    per kernel and path. Updates ``worst`` (max abs error per kernel) and
    returns the kernels line's entries without their launches: each
    kernel's times from the first path that launches it."""
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
                "replaces": SOURCES[kname][1],
                "ms": tot["ms"], "device_ms": tot["device_ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": tot["bound_ms"], "bound_by": bound_by.most_common(1)[0][0],
                "library_ms": tot["library_ms"], "library": LIBRARY[kname]})
    return entries


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
    if "--fp32-request" in sys.argv:
        return fp32_request_ab(sys.argv[sys.argv.index("--fp32-request") + 1:])

    # 1. build
    marks = [("start", time.time())]
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
        which = set(args) & {"conv", "gn", "flash"} or {"conv", "gn", "flash"}
        if "gn" in which:
            sweep_gn(gpu)
        if "flash" in which:
            sweep_flash(gpu)
        if "conv" in which:
            sweep_conv(gpu)
            sweep_conv_fp32(gpu)
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
    # the fp16 instantiation of the 16-bit flash kernel at the towers' shapes
    check_fp16 = []
    for shape in FLASH_FP16_SHAPES:
        m = measure_flash(shape, torch.float16, gen)
        worst["flash_fp16"] = max(worst["flash_fp16"], m["max_abs_err"])
        check_fp16.append(dict(shape=list(shape), dtype="float16", **m))
        emit({"phase": "check", "kernel": NAMES["flash"], "shape": shape,
              "dtype": str(torch.float16), "tol": TOL[torch.float16], **m, "gpu": gpu})

    # the flash kernel at every head width, profiled here: in later phases
    # torch.profiler undercounts the kernel libraries' launches
    flash_widths(gpu)

    marks.append(("build, check", time.time()))

    # 3. the main paths at full width: requests through Restorer.restore on
    # the compiled sampler, against the eager loop
    launches = Counter()
    shapes, engines = {}, {}
    for path, make in (("drift", lambda: flagship_engine(torch.bfloat16)),
                       ("drift_unfused",
                        lambda: flagship_engine(torch.bfloat16, {"fused_gnconv": False})),
                       ("ddpm", lambda: ddpm_engine(torch.bfloat16))):
        t0 = time.time()
        eng = engines[path] = make()
        torch.cuda.synchronize()
        build_s = time.time() - t0
        net_key, n_text = ("n_ema", 1) if path == "ddpm" else ("d_ema", len(FLAGSHIP["ch_mult"]))
        shapes[path] = record_launch_shapes(eng.nets[net_key], unet_args(BATCH, gen, n_text))
        launches.update(serve(path, eng, build_s, gpu))
        if path == "drift":
            launches.update(serve_full_steps(eng, gpu))
    marks.append(("main", time.time()))

    # 3a. the engine accessors (set_sde recaptures, get_visuals) and
    # resize_like's methods on the card
    launches.update(gaps_phase(engines["drift"], gpu))
    marks.append(("gaps", time.time()))

    # 6. every kernel of every path, per UNet forward at that path's own
    # launch shapes; the kernels line takes the first path that launches it
    entries = per_forward(shapes, gen, worst, gpu)
    marks.append(("per_forward", time.time()))

    # 3b. one replayed step alone on the device, profiled, per path
    for path in list(engines):
        emit({"phase": "profile", **profile_step(engines.pop(path), gen, path), "gpu": gpu})
        torch.cuda.empty_cache()
    marks.append(("profile", time.time()))

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

    marks.append(("parity", time.time()))

    # 5. config -> bundle -> compiled sampler -> metrics, and the golden;
    # 5b. testUM --knob, the SMM-less UNet, tracing, on-device metrics, on
    # the same bundle and phantoms
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bundle_") as bundle_tmp:
        got, cfg, opt, fused_means = bundle_phase(gpu, bundle_tmp)
        launches.update(got)
        launches.update(fp32_request(gpu))
        marks.append(("bundle", time.time()))
        launches.update(breadth_phase(gpu, cfg, opt, fused_means))
        marks.append(("breadth", time.time()))


    # 6b. the conditioning encoders: the image tower on the card (on-device
    # emb_A through from_config), BiomedCLIP, precompute_embeddings; after
    # the kernels' timings: after its train step torch.profiler records no
    # kernel of the kernel libraries
    encoded, tower = encoders_phase(gpu, gen, worst)
    launches.update(encoded)
    marks.append(("encoders", time.time()))

    # 6c. the tower breadth: OpenAI RN50 and ViT-B/16 through
    # load_openai_model, BiomedCLIP at fp16, the dense ViT and the context
    # decoders, a train-mode ViT; before train, for the same profiler reason
    towers_launches, towers_shapes = towers_phase(gpu, gen, worst)
    marks.append(("towers", time.time()))

    # 6d. CoCa: coca_ViT-B-32 from an open_clip state dict, its captions,
    # bf16, coca_ViT-L-14's widths (the pooler at D = 96); before train, for
    # the same profiler reason
    coca_launches, coca_shapes = coca_phase(gpu, gen, worst)
    marks.append(("coca", time.time()))

    # 7. training: trainUM at flagship width, resume, serving what it
    # trained; after the kernels' timings, which its profiles would disturb.
    # 8. distillation: the teacher's rollouts on the kernels inside a
    # training loop, at flagship width and on the gate's tiny widths (the
    # gate, a tiny host-bound net in a process of its own, runs beside train)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as gate_tmp:
        gate = start_gate(gpu, gate_tmp)
        try:
            train_phase(gpu)
            marks.append(("train", time.time()))
            distill_phase_chip(gpu, gate)
            marks.append(("distill", time.time()))
        finally:
            if gate[0].poll() is None:
                gate[0].kill()
                gate[0].wait()

    # 9. IR-SDE on the kernels (its launches count in the kernels line), and
    # 10. data-parallel training
    # (dist's (a) runs in the background beside irsde: two trainUM processes,
    # mostly process start, engine build and saves; distill's demo, a tiny
    # host-bound net in a process of its own, runs beside both)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as dist_tmp:
        started = start_dist_launches(dist_tmp)
        demo = start_demo(dist_tmp)
        try:
            launches.update(irsde_phase(gpu))
            marks.append(("irsde", time.time()))
            dist_phase(gpu, started)
            marks.append(("dist", time.time()))
            finish_demo(gpu, demo)
            marks.append(("demo", time.time()))
        finally:
            stop_dist_launches(started)
            if demo[0].poll() is None:
                demo[0].kill()
                demo[0].wait()

    # 11. spatial sharding: the flagship sampler's height split over two
    # ranks, the sharded GroupNorm's two kernel entries (their launches and
    # checks come from the ranks' processes); 12. ZeRO-style FSDP training
    sharded = spatial_phase(gpu)
    marks.append(("spatial", time.time()))
    fsdp_phase(gpu)
    marks.append(("fsdp", time.time()))
    emit({"phase": "timing", "what": "wall seconds of each stretch of the script, in order",
          "seconds": {name: round(t - marks[i][1], 1) for i, (name, t) in
                      enumerate(marks[1:])}, "gpu": gpu})
    entries = {k: dict(e, launches=launches[k], max_abs_err=worst[k]) for k, e in entries.items()}
    entries.update(sharded)
    # the flash row is the UNet bottleneck's (bf16, flash_tc_kernel); the
    # image tower's launches (fp32, flash_tf32x3_kernel) and its shapes'
    # measurements are a field of their own
    entries["flash"]["image_tower"] = {
        "launches": launches["flash_tower"], "launches_dtype": "float32", "per_shape": [
            {k: m[k] for k in ("shape", "dtype", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "max_abs_err")} for m in tower]}
    # the tower breadth's flash launches (fp32 on the split-TF32 kernel, fp16
    # on the 16-bit one) and the measurements of their shapes, and the fp16
    # instantiation's check at the towers' shapes
    entries["flash"]["towers"] = {"launches_by_dtype": dict(towers_launches),
                                  "max_abs_err": worst["flash_towers"],
                                  "per_shape": towers_shapes}
    entries["flash"]["fp16"] = {"launches": towers_launches["float16"],
                                "max_abs_err": worst["flash_fp16"], "check": [
                                    {k: m[k] for k in ("shape", "dtype", "ms", "device_ms",
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "max_abs_err")}
                                    for m in check_fp16]}
    # CoCa's flash launches (fp32 and bf16) and the measurements of their
    # shapes, Nq and Nk apart
    entries["flash"]["coca"] = {"launches_by_dtype": dict(coca_launches),
                                "max_abs_err": worst["flash_coca"], "per_shape": coca_shapes}
    idle = [k for k, e in entries.items() if not e["launches"]] + (
        [] if launches["flash_tower"] else ["flash (image tower)"]) + (
        [] if towers_launches["float16"] and towers_launches["float32"]
        else ["flash (towers, fp16 and fp32)"]) + (
        [] if coca_launches["float32"] and coca_launches["bfloat16"]
        else ["flash (coca, fp32 and bf16)"])
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    entries = list(entries.values())
    emit({"kernels": entries})
    print(gpu, flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
