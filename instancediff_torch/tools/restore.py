"""Restore image files from the command line with a trained bundle (port of
the repository's ``tools/restore.py``).

    python -m instancediff_torch.tools.restore -opt=Configurations/flagship_test.yml \
        --pth-dir experiments/flagship_224/models --images scan0.raw scan1.npy \
        --type "speckle in OCT" --out results/cli

Inputs: ``.raw`` (flat float32, ``--res`` squared), ``.npy`` ([H,W] or
[H,W,1]) or an image file (PIL, grayscale / 255). Unless
``--pre-normalized``, the training pipeline's per-modality normalisation
(``data.med_dataset.normalize_pair``) maps them to [-1, 1]. Writes
``<out>/<stem>_restored.raw`` (float32 in [0,1], ``pred/2 + 0.5``) and a
``.png`` preview, and prints each raw path. Serving goes through
``Restorer.from_config`` (the bundle, the text tower's sidecar, one compiled
sampler on CUDA); the flags are those of ``tools/restore.py`` less
``--platform``, plus ``--device``.

``--spatial N`` splits the images' height over the N ranks of the process
group that launched the tool (``serving.spatial_group``; eagerly, gathered
whole on every rank), and rank 0 alone writes and prints::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m instancediff_torch.tools.restore -opt=... --images ... --spatial 2"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import parallel
from ..config import load_options
from ..data.med_dataset import normalize_pair
from ..serving import Restorer
from ..utils.img_utils import save_img, save_raw, tensor2img


def load_image(path: str, res: int | None):
    """Load one image file as [H,W,1] float32.

    Returns ``(array, is_unit_range)``: raw/npy files carry the modality's
    native scanner range (per-modality clamps apply); PNG/JPG pixels are
    mapped to [0,1] and marked unit-range so the modality clamp-division is
    NOT applied again (it would collapse CT/cryo-EM inputs to ~0)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".raw":
        if not res:
            raise SystemExit(f"--res is required for raw input {path}")
        arr = np.fromfile(path, dtype=np.float32)
        if arr.size != res * res:
            raise SystemExit(
                f"{path}: {arr.size} float32s != --res {res}^2 = {res * res}")
        return arr.reshape(res, res, 1), False
    if ext == ".npy":
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.ndim != 3 or arr.shape[-1] != 1:
            raise SystemExit(f"{path}: expected [H,W] or [H,W,1], got {arr.shape}")
        return arr, False
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float32)[..., None] / 255.0, True


def main(argv=None):
    ap = argparse.ArgumentParser(description="Restore medical images with a trained "
                                             "InstanceDiff bundle")
    ap.add_argument("-opt", default="Configurations/config.yml",
                    help="YAML config (model architecture + SDE + test paths)")
    ap.add_argument("--images", nargs="+", required=True,
                    help="input files (.raw / .npy / .png ...)")
    ap.add_argument("--type", nargs="+", required=True,
                    help="artifact-type prompt(s): one for all images, or one per image "
                         "(e.g. 'speckle in OCT')")
    ap.add_argument("--pth-dir", default=None,
                    help="bundle directory (default: test.pth_dir from the config)")
    ap.add_argument("--iter", default=None,
                    help="bundle iteration (default: test.iter or latest)")
    ap.add_argument("--out", default="results/restore")
    ap.add_argument("--res", type=int, default=None,
                    help="side length for .raw inputs (default: config resolution)")
    ap.add_argument("--sample-steps", type=int, default=None,
                    help="strided fast sampling (< SDE T)")
    ap.add_argument("--eta", type=float, default=None,
                    help="ancestral-noise scale (1=DDPM posterior, 0=DDIM)")
    ap.add_argument("--spatial", type=int, default=0,
                    help="shard the images' height over this many ranks of the launcher's "
                         "process group during sampling")
    ap.add_argument("--batch", type=int, default=None,
                    help="sampler batch size (default: number of images, capped at 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch path")
    ap.add_argument("--pre-normalized", action="store_true",
                    help="inputs are already in [-1,1]; skip the per-modality normalisation")
    ap.add_argument("--no-ema", action="store_true",
                    help="use the online weights instead of the EMA shadows")
    args = ap.parse_args(argv)

    if len(args.type) not in (1, len(args.images)):
        raise SystemExit(f"--type takes 1 or {len(args.images)} names, got {len(args.type)}")
    types = args.type * len(args.images) if len(args.type) == 1 else args.type

    opt = load_options(args.opt)
    res = args.res or opt.get("resolution") or 224
    iteration = args.iter or (opt.get("test") or {}).get("iter") or "latest"

    loaded = [load_image(p, res) for p in args.images]
    shapes = {im.shape for im, _ in loaded}
    if len(shapes) != 1:
        raise SystemExit(f"all images must share one shape, got {shapes}")
    images = []
    for (im, unit_range), t in zip(loaded, types):
        if args.pre_normalized:
            images.append(im)
        elif unit_range:  # already [0,1]: just the global affine to [-1,1]
            images.append(im * 2.0 - 1.0)
        else:
            images.append(normalize_pair(im, im, t)[0])
    stack = np.stack(images).astype(np.float32)

    n = len(images)
    joined = parallel.world_size() > 1
    restorer = Restorer.from_config(
        args.opt, pth_dir=args.pth_dir, iteration=iteration, use_ema=not args.no_ema,
        batch_size=args.batch or min(n, 8), sample_steps=args.sample_steps,
        device=args.device, seed=args.seed, eta=args.eta, spatial=args.spatial)
    unknown = sorted({t for t in types if t not in restorer.type_map})
    if unknown:  # a typo would silently condition on artifact index 0
        raise SystemExit(f"unknown --type {unknown}; valid: {sorted(restorer.type_map)}")

    restored01 = restorer.restore(stack, types) / 2.0 + 0.5  # metric space
    if restorer.sp is not None and not joined:
        parallel.shutdown()
    paths = []
    if restorer.sp is not None and restorer.sp.rank != 0:
        return paths
    os.makedirs(args.out, exist_ok=True)
    for path, rec in zip(args.images, restored01):
        stem = os.path.splitext(os.path.basename(path))[0]
        raw_path = os.path.join(args.out, f"{stem}_restored.raw")
        save_raw(rec, raw_path)
        save_img(tensor2img(rec[..., 0]), os.path.join(args.out, f"{stem}_restored.png"))
        print(raw_path)
        paths.append(raw_path)
    return paths


if __name__ == "__main__":
    main()
