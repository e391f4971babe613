"""All-in-one learning demo: one tiny model trained on all five modalities
(port of the repository's ``tools/demo_all_modalities.py``).

    python -m instancediff_torch.tools.demo_all_modalities [--device cpu]

The JAX demo's settings: 20 phantoms of 32 px, 4 per modality
(``data/synthetic.py``, seed 0), the engine of ``demo_restoration``, 800
steps of batch 10 (batch i the 10 images ``default_rng(i)`` picks), then the
first 5 images (one per modality) restored through ``engine.test``.
``main`` returns, per modality, the degraded and restored PSNR and SSIM."""

from __future__ import annotations

import argparse

from .demo_restoration import restore_and_score, synthetic_arrays, tiny_engine, train

NAMES = ["OCT-Sp", "US-Sp", "CryoEM-N", "LoDose-CT", "MRI-N"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=800, help="train steps (default 800)")
    args = ap.parse_args(argv)
    data = synthetic_arrays(20)
    eng = tiny_engine(args.device)
    train(eng, data, args.steps, 10, 2000, 200)
    scores = restore_and_score(eng, data, 5)
    out = {}
    for j, s in enumerate(scores):
        name = NAMES[int(data["type_idx"][j])]
        out[name] = s
        print(f"{name}: degraded PSNR {s['degraded']['PSNR']:.2f} -> restored "
              f"{s['restored']['PSNR']:.2f} (SSIM {s['degraded']['SSIM']:.3f} -> "
              f"{s['restored']['SSIM']:.3f})", flush=True)
    return out


if __name__ == "__main__":
    main()
