"""Evaluate a trained bundle on a test set (port of the repository's
``testUM.py``).

    python -m instancediff_torch.tools.testUM -opt=Configurations/flagship_test.yml
    python -m torch.distributed.run --nproc_per_node 2 \
        -m instancediff_torch.tools.testUM -opt=... --spatial 2

Loads the bundle ``test.iter`` from ``test.pth_dir`` (its EMA shadows with
``test.use_ema``) and the text tower's sidecar (with ``test.on_device_emb``
the image tower's too, which then embeds each batch's input in place of its
``A_emb``; ``serving.engine_from_config``), restores every batch of each
``datasets.test*``/``val*`` entry on the sampler (on CUDA the compiled one),
scores each image with RMSE/SSIM/PSNR on ``x/2 + 0.5`` at the reference's
settings, writes ``LQ|pred|GT`` triptychs as raw float32 under
``test.result_dir/<artifact type>/`` and prints per-type averages. The flags
are those of ``testUM.py`` less ``--platform``, plus ``--device``.
``--spatial N`` splits each batch's height over the N ranks of the process
group the launcher starts (one per card, ``cuda:LOCAL_RANK``; gloo with
``--device cpu``): every rank restores every batch on its rows
(``serving.spatial_group``, ``engine.test(..., spatial=)``) and rank 0 alone
prints and writes the results. ``--knob name=value`` (repeatable) overrides one key of the
``models.<which_model>.engine`` block, as in ``testUM.py``: the value is an
int when it is digits with an optional ``-``, else a string (``--knob
fused_gnconv=0`` serves the unfused ResBlock body); an unknown key raises
``KeyError`` when the engine is built, before any batch. Noise comes from one ``torch.Generator`` on the device
seeded with ``test.seed``, advancing from batch to batch (the JAX driver
folds the batch index into its key). Returns the per-type lists."""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

from .. import data as data_pkg
from .. import parallel
from ..config import load_options
from ..serving import engine_from_config, spatial_group
from ..utils.img_utils import save_raw
from ..utils.metrics import eval_restoration


def parse_knobs(pairs) -> dict:
    """``name=value`` strings as engine knobs, parsed as ``testUM.py`` parses
    them: an int when the value is digits with an optional ``-``, else the
    string."""
    knobs = {}
    for kv in pairs:
        name, _, val = kv.partition("=")
        knobs[name] = int(val) if val.lstrip("-").isdigit() else val
    return knobs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: the plain PyTorch path")
    parser.add_argument("--sample-steps", type=int, default=None,
                        help="override test.sample_steps (strided fast sampling; "
                             "default = config / full T)")
    parser.add_argument("--eta", type=float, default=None,
                        help="override test.eta (ancestral noise scale; 0 = deterministic)")
    parser.add_argument("--pth-dir", default=None, help="override test.pth_dir")
    parser.add_argument("--iter", default=None, help="override test.iter")
    parser.add_argument("--use-ema", type=int, default=None, choices=(0, 1),
                        help="override test.use_ema (1 = EMA shadows)")
    parser.add_argument("--spatial", type=int, default=0,
                        help="shard the image height over this many ranks (one process "
                             "per card, launched by torch.distributed.run)")
    parser.add_argument("--knob", action="append", default=[],
                        help="engine knob override, name=value (e.g. --knob fused_gnconv=0); "
                             "the keys of the models.*.engine block")
    args = parser.parse_args(argv)

    opt = load_options(args.opt)
    test_opt = opt["test"] or {}
    seed = test_opt.get("seed") or 0
    if args.sample_steps is not None:
        test_opt["sample_steps"] = args.sample_steps
    if args.eta is not None:
        test_opt["eta"] = args.eta
    if args.pth_dir is not None:
        test_opt["pth_dir"] = args.pth_dir
    if args.iter is not None:
        test_opt["iter"] = args.iter
    if args.use_ema is not None:
        test_opt["use_ema"] = bool(args.use_ema)
    result_root = test_opt.get("result_dir") or osp.join(
        os.getcwd(), "results", opt.get("name") or "test")

    loaders = []
    test_batch = int(test_opt.get("batch_size") or 1)
    for phase, dataset_opt in (opt["datasets"] or {}).items():
        if not phase.startswith("test") and not phase.startswith("val"):
            continue
        dataset_opt["phase"] = "test"
        dataset_opt["batch_size"] = test_batch
        ds = data_pkg.create_dataset(dataset_opt)
        loaders.append((phase, data_pkg.create_dataloader(ds, dataset_opt)))
    if not loaders:
        raise ValueError("no test/val dataset entries in config")

    if args.knob:
        model_opt = opt["models"][(opt.get("train") or {}).get("which_model") or "DriftNoise"]
        model_opt["engine"] = dict(model_opt.get("engine") or {}, **parse_knobs(args.knob))
    use_ema = bool(test_opt.get("use_ema"))
    joined = parallel.world_size() > 1
    sp, device = spatial_group(args.spatial, args.device)
    writer = sp is None or sp.rank == 0
    model = engine_from_config(opt, device=device, pth_dir=test_opt.get("pth_dir"),
                               iteration=test_opt.get("iter"), use_ema=use_ema)
    generator = torch.Generator(device=model.device).manual_seed(seed)

    artifact_types = opt.get("artifact_type") or []
    test_results = {name: {"RMSE": [], "SSIM": [], "PSNR": [], "time": [], "num": 0}
                    for name in (artifact_types or ["all"])}
    for phase, loader in loaders:
        for i, batch in enumerate(loader):
            if artifact_types and not any(n in artifact_types for n in batch["names"]):
                continue
            tic = time.time()
            pred = model.test(batch, generator, use_ema=use_ema,
                              sample_steps=test_opt.get("sample_steps"), eta=test_opt.get("eta"),
                              spatial=sp)
            pred = pred.float().cpu().numpy()  # waits for the device
            # amortised per-sample time (batch wall / batch size): a throughput
            # figure, the latency of one sample only at batch 1
            per_sample_t = (time.time() - tic) / len(batch["names"])
            for j, name in enumerate(batch["names"]):
                if artifact_types and name not in artifact_types:
                    continue
                bucket = test_results.setdefault(
                    name, {"RMSE": [], "SSIM": [], "PSNR": [], "time": [], "num": 0})
                m = eval_restoration(pred[j, ..., 0], batch["target"][j, ..., 0])
                for k in ("RMSE", "SSIM", "PSNR"):
                    bucket[k].append(m[k])
                bucket["time"].append(per_sample_t)
                bucket["num"] += 1
                if not writer:
                    continue
                to_save = np.concatenate([batch["input"][j, ..., 0], pred[j, ..., 0],
                                          batch["target"][j, ..., 0]], axis=-1)
                save_raw(to_save, osp.join(
                    result_root, name, f"{i}_{j}_{to_save.shape[-1]}x{to_save.shape[-2]}x1.raw"))
                print(f"\n Testing {i}.{j}, {batch['GT_path'][j]}: RMSE={m['RMSE']}, "
                      f"SSIM={m['SSIM']}, PSNR={m['PSNR']} ({per_sample_t:.2f}s)")

    if sp is not None and not joined:
        parallel.shutdown()
    for name, v in test_results.items():
        if v["num"] == 0 or not writer:
            continue
        message = name
        for k in ("RMSE", "SSIM", "PSNR"):
            message += f", AVG {k}: {sum(v[k]) / v['num']}"
        message += (f", AVG time: {sum(v['time']) / v['num']:.3f}s"
                    " (amortised per sample; = batch latency only at batch 1)")
        print(message)
    return test_results


if __name__ == "__main__":
    main()
