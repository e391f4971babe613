"""Generate a synthetic SpeckleMed-schema dataset (raw float32 files and a
JSON index) and pin it with a manifest (port of the repository's
``tools/make_synth_dataset.py``, the same flags).

    python -m instancediff_torch.tools.make_synth_dataset --root dataset/synth \\
        --res 224 --n-train 16 --n-val 4 --n-test 4

Phantoms degraded per artifact type by ``data/synthetic.py`` (numpy-seeded
noise: the degraded files differ from JAX's generator's, the clean and
embedding files and the index do not). After the files it writes
``MANIFEST.sha256`` (``tools/eval_manifest``) with a ``# generator:`` line
that is this command, so ``tools/eval_protocol --regen`` can rebuild the
set. Prints the index's path."""

from __future__ import annotations

import argparse
import shlex

from ..data.synthetic import write_synthetic_index
from .eval_manifest import write_manifest

COMMAND = "python -m instancediff_torch.tools.make_synth_dataset"


def generator_line(args) -> str:
    """The command that writes this dataset again: this tool with ``args``."""
    parts = ["--root", args.root, "--res", args.res, "--n-train", args.n_train,
             "--n-val", args.n_val, "--n-test", args.n_test, "--emb-dim", args.emb_dim,
             "--seed", args.seed]
    if args.types:
        parts += ["--types", *args.types]
    if args.gt_only:
        parts.append("--gt-only")
    return " ".join([COMMAND] + [shlex.quote(str(p)) for p in parts])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="dataset/synth")
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--n-train", type=int, default=16)
    ap.add_argument("--n-val", type=int, default=4)
    ap.add_argument("--n-test", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--types", nargs="*", default=None,
                    help="restrict artifact types (default: all five)")
    ap.add_argument("--emb-dim", type=int, default=512)
    ap.add_argument("--gt-only", action="store_true",
                    help="write clean images only (no *_A.raw); pair with "
                         "datasets.*.gt_only + models.*.degrade_on_device")
    args = ap.parse_args(argv)
    path = write_synthetic_index(
        args.root, n_train=args.n_train, n_val=args.n_val, n_test=args.n_test,
        res=args.res, seed=args.seed, artifact_types=args.types,
        emb_dim=args.emb_dim, gt_only=args.gt_only)
    write_manifest(args.root, generator_line(args))
    print(path)
    return path


if __name__ == "__main__":
    main()
