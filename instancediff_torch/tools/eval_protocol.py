"""Pinned-manifest evaluation (port of the repository's
``tools/eval_protocol.py``): a quality table only from a dataset that
matches its committed manifest.

    python -m instancediff_torch.tools.eval_protocol --opt Configurations/flagship_test.yml \\
        --tag fp32_T100 [--sample-steps 25 --eta 0] [--device cpu]

1. Verifies ``--dataset-root`` against its ``MANIFEST.sha256``
   (``tools/eval_manifest``) and refuses to score on any drift. With
   ``--regen`` a dataset that does not verify is first rewritten from the
   manifest's ``# generator:`` line, run in this process, when that line is
   the port's own ``tools/make_synth_dataset``; a line naming another
   generator (JAX's ``tools/make_synth_dataset.py``, which runs JAX and
   draws other degraded images) is refused.
2. Runs the port's ``tools/testUM`` in this process on the config with the
   sampler overrides given (``--device``, default cuda).
3. Writes ``<out-dir>/eval_<tag>.json`` (the per-type means, the manifest's
   digest and the sampler settings) and prints the markdown table.

Paths are read from the current directory, as the generator lines and the
configs name them (the repository's root). ``main`` returns the record."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import sys

from . import make_synth_dataset, testUM
from .eval_manifest import MANIFEST_NAME, verify_manifest

PORT_GENERATOR = make_synth_dataset.COMMAND.split()[-1]


def manifest_digest(root):
    with open(os.path.join(root, MANIFEST_NAME), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def regenerate(generator: str) -> None:
    """Run a manifest's generator line when it is the port's
    ``make_synth_dataset`` (``python -m instancediff_torch.tools.
    make_synth_dataset ...``); raise ``SystemExit`` for any other line."""
    words = shlex.split(generator)
    if len(words) < 3 or words[1:3] != ["-m", PORT_GENERATOR] \
            or os.path.basename(words[0]) not in ("python", "python3"):
        raise SystemExit(
            f"refusing to run the generator line {generator!r}: only the port's own "
            f"'{make_synth_dataset.COMMAND} ...' is run here. A line naming "
            "tools/make_synth_dataset.py runs the JAX package, whose threefry draws give "
            "other degraded images than the port's generator, so the set would not match "
            "its manifest; write the files with the generator that pinned them")
    print(f"[protocol] regenerating: {generator}", file=sys.stderr)
    make_synth_dataset.main(words[3:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--dataset-root", default="dataset/flagship224")
    ap.add_argument("--tag", required=True, help="artifact tag, e.g. fp32_T100")
    ap.add_argument("--sample-steps", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--pth-dir", default=None, help="override test.pth_dir (distilled bundles)")
    ap.add_argument("--iter", dest="ckpt_iter", default=None, help="override test.iter")
    ap.add_argument("--use-ema", dest="use_ema", type=int, default=None, choices=(0, 1),
                    help="override test.use_ema")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch path")
    ap.add_argument("--out-dir", default="artifacts",
                    help="where eval_<tag>.json is written (default: artifacts/)")
    ap.add_argument("--regen", action="store_true",
                    help="regenerate the dataset from the manifest's generator line first "
                         "(the port's generator only), then verify")
    args = ap.parse_args(argv)

    if args.regen:
        ok, _, generator = verify_manifest(args.dataset_root)
        if not ok:
            if not generator:
                raise SystemExit("manifest has no generator line; cannot regen")
            regenerate(generator)
    ok, problems, generator = verify_manifest(args.dataset_root)
    if not ok:
        for p in problems:
            print(p, file=sys.stderr)
        raise SystemExit(
            f"dataset {args.dataset_root} does not match its pinned manifest "
            f"— refusing to emit a quality table on drifted data"
            + (f"; regenerate with: {generator}" if generator else ""))
    digest = manifest_digest(args.dataset_root)
    print(f"[protocol] manifest verified (digest {digest[:16]}...)", file=sys.stderr)

    argv_um = [f"-opt={args.opt}", "--device", args.device]
    if args.sample_steps is not None:
        argv_um += ["--sample-steps", str(args.sample_steps)]
    if args.eta is not None:
        argv_um += ["--eta", str(args.eta)]
    if args.pth_dir:
        argv_um += ["--pth-dir", args.pth_dir]
    if args.ckpt_iter:
        argv_um += ["--iter", args.ckpt_iter]
    if args.use_ema is not None:
        argv_um += ["--use-ema", str(args.use_ema)]
    results = testUM.main(argv_um)

    table = {}
    for name, v in results.items():
        if v["num"] == 0:
            continue
        table[name] = {"PSNR": sum(v["PSNR"]) / v["num"], "SSIM": sum(v["SSIM"]) / v["num"],
                       "RMSE": sum(v["RMSE"]) / v["num"], "n": v["num"]}
    record = {"tag": args.tag, "opt": args.opt, "dataset_root": args.dataset_root,
              "manifest_sha256": digest, "sample_steps": args.sample_steps, "eta": args.eta,
              "pth_dir": args.pth_dir, "iter": args.ckpt_iter, "device": args.device,
              "table": table}
    out_path = os.path.join(args.out_dir, f"eval_{args.tag}.json")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(f"[protocol] wrote {out_path}", file=sys.stderr)

    print(f"\n| Modality | PSNR | SSIM | RMSE | n | ({args.tag}, manifest {digest[:12]}) |")
    print("|---|---|---|---|---|---|")
    for name, row in table.items():
        print(f"| {name} | {row['PSNR']:.2f} | {row['SSIM']:.4f} | {row['RMSE']:.4f} | "
              f"{row['n']} | |")
    return record


if __name__ == "__main__":
    main()
