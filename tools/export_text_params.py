"""Write the frozen text tower's weights beside a weight bundle, for the
PyTorch port.

A bundle (``{iter}_DN.ckpt`` ...) holds the nets but not the frozen CLIP text
tower: the JAX engine draws the tower from its seed at construction (or reads
``text_encoder_pretrain_path``). The port cannot draw JAX's random numbers,
so it reads the tower from ``<models dir>/text_params.ckpt``, which this
script writes: it builds the JAX engine of ``-opt`` with ``--seed`` and saves
``engine.text_params`` with ``instancediff_tpu.utils.checkpoint.save_pytree``.

The seed must be the one the bundle was trained with: ``trainUM.py`` builds
its engine from ``train.manual_seed`` (the default here), while ``testUM.py``
uses ``test.seed`` and ``Restorer.from_config`` 0.

Example:
    python tools/export_text_params.py -opt=Configurations/tiny_cpu.yml \
        --models-dir experiments/tiny_cpu_e2e/models --platform cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIDECAR = "text_params.ckpt"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Export the frozen text tower's weights "
                                             "for the PyTorch port")
    ap.add_argument("-opt", required=True, help="the training YAML config")
    ap.add_argument("--models-dir", default=None,
                    help="the bundle's directory (default: test.pth_dir from the config)")
    ap.add_argument("--seed", type=int, default=None,
                    help="the engine's seed (default: train.manual_seed, else 0)")
    ap.add_argument("--platform", default=None, help="force a jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import yaml

    from instancediff_tpu.config import dict_to_nonedict, ordered_yaml
    from instancediff_tpu.models import create_model
    from instancediff_tpu.utils.checkpoint import save_pytree

    loader, _ = ordered_yaml()
    with open(args.opt) as f:
        opt = dict_to_nonedict(yaml.load(f, Loader=loader))
    train_opt = opt.get("train") or {}
    seed = args.seed if args.seed is not None else (train_opt.get("manual_seed") or 0)
    models_dir = args.models_dir or (opt.get("test") or {}).get("pth_dir")
    if not models_dir:
        raise SystemExit("no --models-dir and no test.pth_dir in the config")
    model_opt = opt["models"][train_opt.get("which_model") or "DriftNoise"]
    engine = create_model(train_opt, model_opt, phase="test",
                          image_size=opt.get("resolution") or 224, seed=seed)
    path = os.path.join(models_dir, SIDECAR)
    save_pytree(engine.text_params, path)
    print(path)
    return path


if __name__ == "__main__":
    main()
