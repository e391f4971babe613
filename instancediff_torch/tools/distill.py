"""Progressive few-step distillation of a trained bundle (port of the
repository's ``tools/distill.py``; the phases are ``models/distill.py``).

    python -m instancediff_torch.tools.distill -opt=Configurations/flagship_tpu.yml \\
        --phases 50 25 --steps-per-phase 1500 --lr 2e-5 \\
        --out-dir experiments/flagship_224_distill/models

Loads the bundle ``--ckpt-iter`` (default ``test.iter``, else "latest")
from ``--ckpt-dir`` (default ``test.pth_dir``) with its EMA shadows and its
text tower's sidecar into a training engine of the config, sets the
config's SDE and runs one phase per ``--phases`` entry, each halving the
sampler's steps: the first phase's teacher is the bundle's EMA sampler (its
live nets with ``--raw-teacher``) at ``--teacher-eta``; each later phase's
teacher is the previous student, distilled deterministically. After each
phase the bundle ``distill{N}`` is written to ``--out-dir`` in the layout
JAX writes, with the text tower's sidecar, so ``tools/testUM --sample-steps N
--eta 0 --iter distill{N} --pth-dir <out-dir>`` serves it unchanged. The
flags are JAX's, with ``--device`` (default cuda; cpu: the plain PyTorch
path) in place of ``--platform``. Batches come from the config's train
split in ``DistIterSampler``'s epoch-seeded order; step draws from one
generator on the device seeded with ``--seed``. ``main`` returns the
engine."""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import data as data_pkg
from ..config import load_options
from ..models import create_model
from ..models.distill import distill_phase
from ..sde import create_sde
from .trainUM import seeded_generator


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("-opt", type=str, required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch path")
    ap.add_argument("--ckpt-dir", default=None, help="weight bundle dir (default: test.pth_dir)")
    ap.add_argument("--ckpt-iter", default=None, help="bundle iteration (default: test.iter)")
    ap.add_argument("--phases", type=int, nargs="+", required=True,
                    help="student step counts, halving per phase (e.g. 50 25 from a T=100 "
                         "teacher)")
    ap.add_argument("--steps-per-phase", type=int, default=1500)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--batch", type=int, default=None,
                    help="distill batch (default: train dataset batch_size)")
    ap.add_argument("--out-dir", default=None,
                    help="bundle output dir (default: experiments/<name>_distill/models)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--raw-teacher", action="store_true",
                    help="use the raw (non-EMA) weights as the first teacher")
    ap.add_argument("--teacher-eta", type=float, default=0.0,
                    help="eta of the teacher chain distilled in phase 1 (1.0: the student's "
                         "deterministic step regresses onto the stochastic chain's "
                         "conditional mean); later phases distill deterministically")
    ap.add_argument("--z1-correction", action="store_true",
                    help="include the exact -c1*z1 term in the stochastic teacher's noise "
                         "target")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    opt = load_options(args.opt)
    train_opt = opt.get("train") or {}
    which_model = train_opt.get("which_model") or "DriftNoise"
    eng = create_model(train_opt, opt["models"][which_model], phase="train",
                       sde=create_sde(opt["sdes"][train_opt.get("which_sde") or "driftSDE"]),
                       image_size=opt.get("resolution") or 224, seed=args.seed,
                       device=args.device)
    test_opt = opt.get("test") or {}
    ckpt_dir = args.ckpt_dir or test_opt.get("pth_dir")
    ckpt_iter = args.ckpt_iter or test_opt.get("iter") or "latest"
    if not ckpt_dir:
        raise SystemExit("no checkpoint dir (--ckpt-dir or test.pth_dir)")
    print(f"[distill] loading {ckpt_dir} @ {ckpt_iter}", file=sys.stderr)
    eng.load(ckpt_dir, ckpt_iter, load_ema=True)

    ds_opt = dict(opt["datasets"]["train"])
    ds_opt["phase"] = "train"
    if args.batch:
        ds_opt["batch_size"] = args.batch
    ds = data_pkg.create_dataset(ds_opt)
    loader = data_pkg.create_dataloader(ds, ds_opt, data_pkg.DistIterSampler(len(ds)))
    if len(loader) == 0:
        raise ValueError(f"the train split has {len(ds)} images, fewer than one batch of "
                         f"{ds_opt['batch_size']}")

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    out_dir = args.out_dir or os.path.join(
        "experiments", f"{opt.get('name') or 'model'}_distill", "models")
    os.makedirs(out_dir, exist_ok=True)
    generator = seeded_generator(eng.device, args.seed, 31337)
    for pi, n_student in enumerate(args.phases):
        t0 = time.time()
        phase_eta = args.teacher_eta if pi == 0 else 0.0
        ema_teacher = pi == 0 and not args.raw_teacher
        print(f"[distill] phase {pi + 1}/{len(args.phases)}: teacher "
              f"{'EMA ' if ema_teacher else ''}grid 2x{n_student} (eta={phase_eta}) -> "
              f"student T={n_student}, {args.steps_per_phase} steps, lr {args.lr}",
              file=sys.stderr)

        def log_fn(s, m, _n=n_student, _t0=t0):
            print(f"[distill] T={_n} step {s}/{args.steps_per_phase} l={m['l']:.5f} "
                  f"dl={m['dl']:.5f} nl={m['nl']:.5f} ({time.time() - _t0:.0f}s)",
                  file=sys.stderr)

        distill_phase(eng, n_student, batches(), args.steps_per_phase, lr=args.lr,
                      ema_as_teacher=ema_teacher, teacher_eta=phase_eta,
                      z1_correction=args.z1_correction,
                      log_every=max(1, args.steps_per_phase // 10), log_fn=log_fn,
                      generator=generator)
        tag = f"distill{n_student}"
        eng.save(out_dir, tag)
        print(f"[distill] phase done in {time.time() - t0:.0f}s; saved bundle '{tag}' to "
              f"{out_dir}", file=sys.stderr)
    print(f"[distill] all phases done. Evaluate with:\n  python -m "
          f"instancediff_torch.tools.testUM -opt={args.opt} --sample-steps {args.phases[-1]} "
          f"--eta 0 --pth-dir {out_dir} --iter distill{args.phases[-1]}", file=sys.stderr)
    return eng


if __name__ == "__main__":
    main()
