"""End-to-end learning demo: a small drift-diffusion model trained on
synthetic OCT speckle, then restoring (port of the repository's
``tools/demo_restoration.py``).

    python -m instancediff_torch.tools.demo_restoration [--device cpu]

The JAX demo's settings: 16 phantoms of 32 px (``data/synthetic.py``, seed
0), the dual UNets at nf 16, ch_mult [1, 2] with the tiny text tower, T=16,
max_sigma 0.3, learning rate 2e-3, 600 steps of batch 8 (batch i the 8
images ``default_rng(i)`` picks) through ``optimize_parameters``, then the
first 4 images restored through ``engine.test`` (the full grid, eta 1, the
live nets; on CUDA the compiled sampler and the kernels). ``main`` returns
each image's degraded and restored PSNR and SSIM."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data.synthetic import SyntheticMedDataset
from ..models.drift_model import CLIPDriftEngine
from ..sde import DriftSDE
from ..utils.metrics import eval_restoration

TINY = dict(in_nc=2, out_nc=5, nf=16, ch_mult=[1, 2], context_dim=16, text_module="scoremap",
            score_map_chan=4, if_MultiScoreMap=True, num_res_blocks=1)


def tiny_engine(device, seed: int = 0) -> CLIPDriftEngine:
    """The demos' trainable engine (and the distillation gate's teacher)."""
    return CLIPDriftEngine(TINY, TINY, score_map_ch_mult=(1, 1), score_map_ngf=16,
                           use_image_context=True, CLIP_Type="CLIP", tiny_text_encoder=True,
                           sde=DriftSDE(T=16, max_sigma=0.3), image_size=32, nepoch=100,
                           drift_net_lr=2e-3, noise_net_lr=2e-3, seed=seed, if_train=True,
                           device=device)


def synthetic_arrays(n: int, artifact_types=None) -> dict:
    """``n`` 32 px phantoms of ``SyntheticMedDataset`` (seed 0, 16-wide
    embeddings) as stacked arrays: input, target, type_idx, A_emb."""
    ds = SyntheticMedDataset(n=n, res=32, artifact_types=artifact_types, seed=0, emb_dim=16)
    items = [ds[i] for i in range(n)]
    return {"input": np.stack([it["LQ"] for it in items]),
            "target": np.stack([it["GT"] for it in items]),
            "type_idx": np.asarray([int(it["type_idx"]) for it in items], np.int64),
            "A_emb": np.stack([it["A_emb"] for it in items])}


def train(eng, data: dict, n_steps: int, batch: int, key0: int, log_every: int) -> float:
    """``n_steps`` train steps; step i takes the images
    ``default_rng(i).choice(n, batch)`` and draws from a generator seeded
    ``key0 + i``; the epoch is ``i * 100 // n_steps``. Returns the last loss."""
    n = len(data["target"])
    t0 = time.time()
    loss = float("nan")
    for i in range(n_steps):
        idx = np.random.default_rng(i).choice(n, batch, replace=False)
        gen = torch.Generator(device=eng.device).manual_seed(key0 + i)
        loss = eng.optimize_parameters({k: v[idx] for k, v in data.items()}, gen,
                                       epoch=i * 100 // n_steps)
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {loss:.4f} ({time.time() - t0:.0f}s)", flush=True)
    print(f"final loss {loss:.4f} after {time.time() - t0:.0f}s", flush=True)
    return loss


def restore_and_score(eng, data: dict, n: int, **test_kw) -> list:
    """The first ``n`` images through ``engine.test`` (generator seed 7,
    live nets unless ``use_ema`` is given): per image the degraded and the
    restored PSNR and SSIM against the target."""
    batch = {k: v[:n] for k, v in data.items()}
    test_kw.setdefault("use_ema", False)
    out = eng.test(batch, torch.Generator(device=eng.device).manual_seed(7), **test_kw)
    out = out.float().cpu().numpy()
    scores = []
    for j in range(n):
        deg = eval_restoration(batch["input"][j, ..., 0], batch["target"][j, ..., 0])
        res = eval_restoration(out[j, ..., 0], batch["target"][j, ..., 0])
        scores.append({"degraded": {k: deg[k] for k in ("PSNR", "SSIM")},
                       "restored": {k: res[k] for k in ("PSNR", "SSIM")}})
    return scores


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=600, help="train steps (default 600)")
    args = ap.parse_args(argv)
    data = synthetic_arrays(16, ["speckle in OCT"])
    eng = tiny_engine(args.device)
    train(eng, data, args.steps, 8, 1000, 100)
    scores = restore_and_score(eng, data, 4)
    for j, s in enumerate(scores):
        print(f"img{j}: degraded PSNR {s['degraded']['PSNR']:.2f} SSIM "
              f"{s['degraded']['SSIM']:.3f} -> restored PSNR {s['restored']['PSNR']:.2f} "
              f"SSIM {s['restored']['SSIM']:.3f}", flush=True)
    return scores


if __name__ == "__main__":
    main()
