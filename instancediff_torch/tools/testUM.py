"""Evaluate a trained bundle on a test set (port of the repository's
``testUM.py``).

    python -m instancediff_torch.tools.testUM -opt=Configurations/flagship_test.yml

Loads the bundle ``test.iter`` from ``test.pth_dir`` (its EMA shadows with
``test.use_ema``) and the text tower's sidecar, restores every batch of each
``datasets.test*``/``val*`` entry on the sampler (on CUDA the compiled one),
scores each image with RMSE/SSIM/PSNR on ``x/2 + 0.5`` at the reference's
settings, writes ``LQ|pred|GT`` triptychs as raw float32 under
``test.result_dir/<artifact type>/`` and prints per-type averages. The flags
are those of ``testUM.py`` less ``--platform``, ``--spatial`` and ``--knob``,
plus ``--device``. Noise comes from one ``torch.Generator`` on the device
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
from ..config import load_options
from ..serving import engine_from_config
from ..utils.img_utils import save_raw
from ..utils.metrics import eval_restoration


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

    use_ema = bool(test_opt.get("use_ema"))
    model = engine_from_config(opt, device=args.device, pth_dir=test_opt.get("pth_dir"),
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
                              sample_steps=test_opt.get("sample_steps"), eta=test_opt.get("eta"))
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
                to_save = np.concatenate([batch["input"][j, ..., 0], pred[j, ..., 0],
                                          batch["target"][j, ..., 0]], axis=-1)
                save_raw(to_save, osp.join(
                    result_root, name, f"{i}_{j}_{to_save.shape[-1]}x{to_save.shape[-2]}x1.raw"))
                print(f"\n Testing {i}.{j}, {batch['GT_path'][j]}: RMSE={m['RMSE']}, "
                      f"SSIM={m['SSIM']}, PSNR={m['PSNR']} ({per_sample_t:.2f}s)")

    for name, v in test_results.items():
        if v["num"] == 0:
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
