"""Pin an evaluation dataset: a per-file SHA256 manifest and the command
that generates the files (port of the repository's
``tools/eval_manifest.py``; the same bytes and the same CLI).

    write:  python -m instancediff_torch.tools.eval_manifest write <root> \\
                --generator "<command that writes the dataset>"
    verify: python -m instancediff_torch.tools.eval_manifest verify <root>

``write`` hashes every file under ``root`` (the index and the raw images)
into ``root/MANIFEST.sha256``, after a ``# generator:`` line when one is
given. ``verify`` reports every missing, extra or changed file and exits
non-zero on any; ``tools/eval_protocol`` runs it before it scores a bundle."""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

MANIFEST_NAME = "MANIFEST.sha256"


def _iter_files(root):
    for dirpath, _, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn == MANIFEST_NAME:
                continue
            p = os.path.join(dirpath, fn)
            yield os.path.relpath(p, root).replace(os.sep, "/")


def _sha256(path, bufsize=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(bufsize)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def write_manifest(root, generator=None):
    """Write ``root/MANIFEST.sha256``; returns (its path, files hashed)."""
    lines = []
    if generator:
        lines.append(f"# generator: {generator}")
    n = 0
    for rel in _iter_files(root):
        lines.append(f"{_sha256(os.path.join(root, rel))}  {rel}")
        n += 1
    path = os.path.join(root, MANIFEST_NAME)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, n


def verify_manifest(root):
    """Returns (ok: bool, problems: list[str], generator: str|None)."""
    path = os.path.join(root, MANIFEST_NAME)
    if not os.path.isfile(path):
        return False, [f"no {MANIFEST_NAME} in {root}"], None
    expected = {}
    generator = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                if line.startswith("# generator: "):
                    generator = line[len("# generator: "):]
                continue
            digest, rel = line.split("  ", 1)
            expected[rel] = digest
    problems = []
    actual_files = set(_iter_files(root))
    for rel in sorted(set(expected) - actual_files):
        problems.append(f"missing: {rel}")
    for rel in sorted(actual_files - set(expected)):
        problems.append(f"extra (not in manifest): {rel}")
    for rel in sorted(set(expected) & actual_files):
        if _sha256(os.path.join(root, rel)) != expected[rel]:
            problems.append(f"hash mismatch: {rel}")
    return not problems, problems, generator


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("write")
    w.add_argument("root")
    w.add_argument("--generator", default=None,
                   help="exact command that (re)generates this dataset")
    v = sub.add_parser("verify")
    v.add_argument("root")
    args = ap.parse_args(argv)

    if args.cmd == "write":
        path, n = write_manifest(args.root, args.generator)
        print(f"wrote {path} ({n} files)")
        return
    ok, problems, generator = verify_manifest(args.root)
    if ok:
        print(f"manifest OK: {args.root} "
              f"({'generator: ' + generator if generator else 'no generator line'})")
        return
    for p in problems:
        print(p, file=sys.stderr)
    if generator:
        print(f"regenerate with: {generator}", file=sys.stderr)
    raise SystemExit(1)


if __name__ == "__main__":
    main()
