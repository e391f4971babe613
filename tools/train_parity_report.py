"""Print what the port's train-step parity checks read against the JAX golden
(``tests/data_torch/train_golden``): for every case of
``tools/make_train_golden.py``, ``tests/test_torch_train.py:check_against``'s
readings (the first moments' worst error per leaf, the leaves on the floor,
the elements that took Adam's allowance), and for the bf16 case how far
JAX's own bf16 step lies from its fp32 step beside the port's, over all
leaves and per top-level module of each net.

    JAX_PLATFORMS=cpu python tools/train_parity_report.py [case ...] [--variant NAME]

``--variant`` changes the port's engine before its step, to attribute the
bf16 distance: ``text_fp32`` runs the frozen text tower in float32,
``quick_gelu_xla`` rounds its QuickGELU in bf16 step by step as XLA rounds
JAX's (the constant, the product, exp, the add and the reciprocal).

One JSON object per line; the CPU only, no JAX engine is built."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

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
        modules = {}
        for k, j, p in zip(ref, dj, dp):
            modules.setdefault(k.split("/")[1], []).append((j, p))
        leaf = "params/smm_0/logit_scale"
        out[key] = {"jax_bf16_vs_fp32_median": float(np.median(dj)),
                    "jax_bf16_vs_fp32_max": max(dj),
                    "port_bf16_vs_fp32_median": float(np.median(dp)),
                    "port_bf16_vs_fp32_max": max(dp),
                    "logit_scale_fp32_jax_bf16_port_bf16": [float(ref[leaf]), float(jax_b[leaf]),
                                                            float(port_b[leaf])],
                    "median_by_module_jax_bf16_port_bf16": {
                        m: [float(np.median([j for j, _ in v])),
                            float(np.median([p for _, p in v])), len(v)]
                        for m, v in modules.items()}}
    return out


def _text_fp32(eng) -> None:
    from instancediff_torch.models.layers import cast_compute_

    cast_compute_(eng.text_encoder, torch.float32).float()


def _quick_gelu_xla(eng) -> None:
    from instancediff_torch.models.text_encoder import TransformerBlock

    def act(x):  # 1.702 rounded to bf16 is 1.703125
        return x * (1 / (1 + torch.exp(-(x * 1.703125))))

    for m in eng.text_encoder.modules():
        if isinstance(m, TransformerBlock):
            m.act = act


VARIANTS = {"text_fp32": _text_fp32, "quick_gelu_xla": _quick_gelu_xla}


def main(names, variant=None) -> None:
    import test_torch_train as T
    from instancediff_torch.utils import checkpoint as ckpt
    from tools import make_train_golden as golden

    torch.set_num_threads(2)
    arrays = ckpt.load_pytree(os.path.join(golden.OUT, "golden.ckpt"))
    with open(os.path.join(golden.OUT, "losses.json")) as f:
        losses = json.load(f)
    for name in names or golden.CASES:
        eng = T.port_engine(name)
        line = {"case": name}
        if variant:
            VARIANTS[variant](eng)
            line["variant"] = variant
        got = T.run_port(eng, arrays[name])
        if variant:  # the checks hold the port as it is, not a variant
            line["losses"] = got[0]
        else:
            line.update(T.check_against(name, eng, got, arrays[name], losses[name],
                                        (arrays, losses)))
        if name in T.FP32_CASE:
            line["bf16_spread"] = bf16_spread(name, got[1], arrays)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    import argparse

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    parser = argparse.ArgumentParser()
    parser.add_argument("cases", nargs="*")
    parser.add_argument("--variant", choices=sorted(VARIANTS))
    args = parser.parse_args()
    main(args.cases, args.variant)
