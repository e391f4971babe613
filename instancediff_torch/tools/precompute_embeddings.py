"""Precompute the image embeddings ``emb_A`` of a dataset index (port of the
repository's ``tools/precompute_embeddings.py``): the reference's offline
workflow, for a model served with ``A_emb`` files instead of the on-device
tower.

    python -m instancediff_torch.tools.precompute_embeddings \
        --index dataset/synth/dataset_file.json [--res 224] [--tiny] \
        (--checkpoint open_clip_pytorch_model.bin | --params visual.ckpt) \
        [--batch 8] [--device cuda]

For every record of every split: read ``A`` (raw float32, res x res),
``normalize_pair`` it, embed it with BiomedCLIP's ``encode_image``
(L2-normalised), write the embedding as raw float32 to the record's
``A_emb`` (default: ``A`` with ``.raw`` -> ``_emb.raw``), and rewrite the
index with each record's ``A_emb``. The weights come from an open_clip
state dict (``--checkpoint``) or from the visual tower's flax tree
(``--params``, written with JAX by ``tools/export_image_params.py
--biomedclip``); the port draws none. Runs on the card unless
``--device cpu``. Returns the number of images embedded."""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.med_dataset import normalize_pair
from ..models.biomedclip import get_BiomedCLIP


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--checkpoint", default=None, help="an open_clip torch state dict")
    ap.add_argument("--params", default=None,
                    help="the visual tower's flax tree (tools/export_image_params.py "
                         "--biomedclip)")
    ap.add_argument("--batch", type=int, default=8, help="images per encode_image call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = get_BiomedCLIP(checkpoint_path=args.checkpoint, params=args.params, tiny=args.tiny,
                           device=args.device)
    with open(args.index) as f:
        index = json.load(f)
    records = [rec for recs in index.values() for rec in recs]
    for s in range(0, len(records), args.batch):
        chunk = records[s:s + args.batch]
        images = []
        for rec in chunk:
            a = np.fromfile(rec["A"], dtype=np.float32).reshape(args.res, args.res, 1)
            images.append(normalize_pair(a, a.copy(), rec["name"])[0])
        emb = model.encode_image(np.stack(images)).float().cpu().numpy()
        for rec, e in zip(chunk, emb):
            path = rec.get("A_emb") or rec["A"].replace(".raw", "_emb.raw")
            e.astype(np.float32).tofile(path)
            rec["A_emb"] = path
    with open(args.index, "w") as f:
        json.dump(index, f, indent=1)
    print(f"embedded {len(records)} images -> {args.index}")
    return len(records)


if __name__ == "__main__":
    main()
