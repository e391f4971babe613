"""Print what the port's train-step parity checks read against the JAX golden
(``tests/data_torch/train_golden``): for every case of
``tools/make_train_golden.py``, ``tests/test_torch_train.py:check_against``'s
readings (the first moments' worst error per leaf, the leaves on the floor,
the elements that took Adam's allowance), and for the bf16 case how far
JAX's own bf16 step lies from its fp32 step beside the port's.

    JAX_PLATFORMS=cpu python tools/train_parity_report.py [case ...]

One JSON object per line; the CPU only, no JAX engine is built."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def bf16_spread(name, moments, arrays) -> dict:
    """Per trained net: the median and largest per-leaf distance (as a share
    of the fp32 leaf's largest magnitude) of JAX's bf16 first moments and
    of the port's from JAX's fp32 ones, and the noise net's
    ``smm_0/logit_scale`` in each."""
    import test_torch_train as T
    from tools import make_train_golden as golden

    out = {}
    fp32 = arrays[T.FP32_CASE[name]]
    for key in golden.trained_keys(golden.CASES[name][0]):
        ref = T._flat(golden.subset(fp32["mu1"][key]))
        jax_b = T._flat(arrays[name]["mu1"][key])
        port_b = T._flat(golden.subset(moments[1][key]))

        def dist(tree):
            return [float(np.abs(tree[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30))
                    for k in ref]

        dj, dp = dist(jax_b), dist(port_b)
        leaf = "params/smm_0/logit_scale"
        out[key] = {"jax_bf16_vs_fp32_median": float(np.median(dj)),
                    "jax_bf16_vs_fp32_max": max(dj),
                    "port_bf16_vs_fp32_median": float(np.median(dp)),
                    "port_bf16_vs_fp32_max": max(dp),
                    "logit_scale_fp32_jax_bf16_port_bf16": [float(ref[leaf]), float(jax_b[leaf]),
                                                            float(port_b[leaf])]}
    return out


def main(names) -> None:
    import torch

    import test_torch_train as T
    from instancediff_torch.utils import checkpoint as ckpt
    from tools import make_train_golden as golden

    torch.set_num_threads(2)
    arrays = ckpt.load_pytree(os.path.join(golden.OUT, "golden.ckpt"))
    with open(os.path.join(golden.OUT, "losses.json")) as f:
        losses = json.load(f)
    for name in names or golden.CASES:
        eng = T.port_engine(name)
        got = T.run_port(eng, arrays[name])
        line = {"case": name, **T.check_against(name, eng, got, arrays[name], losses[name],
                                                (arrays, losses))}
        if name in T.FP32_CASE:
            line["bf16_spread"] = bf16_spread(name, got[1], arrays)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
