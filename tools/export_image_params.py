"""Write the on-device image tower's weights for the PyTorch port.

With ``test.on_device_emb`` the JAX ``Restorer.from_config`` and
``testUM.py`` build ``clip_vit.build_image_tower(embed_dim=context_dim,
tiny=tiny_text_encoder)`` and draw its weights from ``jax.random.key(7)`` on
a ``(1, resolution, resolution, 1)`` input. The port cannot draw JAX's
random numbers, so it reads that tower from ``<models dir>/image_params.ckpt``,
which this script writes with ``instancediff_tpu.utils.checkpoint.save_pytree``.

With ``--biomedclip`` it writes instead the visual tower that
``get_BiomedCLIP(seed=S, tiny=...)`` draws (``instancediff_tpu/models/
biomedclip.py``) to ``--out``, and with ``--text-out`` its text tower too:
the weights the port's ``get_BiomedCLIP(params=..., text_params=...)`` and
``instancediff_torch.tools.precompute_embeddings --params`` read.

Examples:
    python tools/export_image_params.py -opt=Configurations/flagship_test.yml \
        --models-dir experiments/flagship_224/models
    python tools/export_image_params.py --biomedclip --tiny --seed 0 \
        --out biomedclip_visual.ckpt --platform cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIDECAR = "image_params.ckpt"
TOWER_KEY = 7  # the key JAX's from_config and testUM draw the tower from


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description="Export the image tower's weights for the "
                                             "PyTorch port")
    ap.add_argument("-opt", default=None, help="the serving YAML config")
    ap.add_argument("--models-dir", default=None,
                    help="the bundle's directory (default: test.pth_dir from the config)")
    ap.add_argument("--out", default=None, help="the file to write (overrides --models-dir)")
    ap.add_argument("--biomedclip", action="store_true",
                    help="write get_BiomedCLIP's visual tower instead of the config's tower")
    ap.add_argument("--seed", type=int, default=0, help="get_BiomedCLIP's seed")
    ap.add_argument("--tiny", action="store_true", help="get_BiomedCLIP's tiny towers")
    ap.add_argument("--text-out", default=None,
                    help="with --biomedclip: also write its text tower here")
    ap.add_argument("--platform", default=None, help="force a jax platform (e.g. cpu)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from instancediff_tpu.utils.checkpoint import save_pytree

    if args.biomedclip:
        from instancediff_tpu.models.biomedclip import get_BiomedCLIP

        if not args.out:
            raise SystemExit("--biomedclip needs --out")
        model = get_BiomedCLIP(tiny=args.tiny, seed=args.seed)
        save_pytree(model.visual_params, args.out)
        if args.text_out:
            save_pytree(model.text_params, args.text_out)
        print(args.out)
        return args.out

    import jax.numpy as jnp
    import yaml

    from instancediff_tpu.config import dict_to_nonedict, ordered_yaml
    from instancediff_tpu.models.clip_vit import build_image_tower

    if not args.opt:
        raise SystemExit("-opt is required (or --biomedclip)")
    loader, _ = ordered_yaml()
    with open(args.opt) as f:
        opt = dict_to_nonedict(yaml.load(f, Loader=loader))
    model_opt = opt["models"][(opt.get("train") or {}).get("which_model") or "DriftNoise"]
    # the engine's context_dim: the drift engine's dnet_settings, the DDPM
    # engine's net_settings
    settings = model_opt.get("dnet_settings") or model_opt.get("net_settings") or {}
    res = opt.get("resolution") or 224
    tower = build_image_tower(embed_dim=settings.get("context_dim", 512),
                              tiny=bool(model_opt.get("tiny_text_encoder")))
    params = jax.jit(lambda k: tower.init(k, jnp.zeros((1, res, res, 1))))(
        jax.random.key(TOWER_KEY))
    path = args.out
    if not path:
        models_dir = args.models_dir or (opt.get("test") or {}).get("pth_dir")
        if not models_dir:
            raise SystemExit("no --out, no --models-dir and no test.pth_dir in the config")
        path = os.path.join(models_dir, SIDECAR)
    save_pytree(params, path)
    print(path)
    return path


if __name__ == "__main__":
    main()
