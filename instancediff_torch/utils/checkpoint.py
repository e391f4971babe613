"""Weight bundles in the JAX package's layout (port of
``instancediff_tpu/utils/checkpoint.py``), on the flax msgpack codec of
``utils/msgpack.py``.

Per iteration ``{iter}_DN.ckpt`` and ``{iter}_NN.ckpt`` (the drift and noise
nets without their score-map prompts) and, when the nets have prompts,
``{iter}_DP.ckpt`` and ``{iter}_NP.ckpt`` (the ``smm_*`` subtrees); the EMA
shadows under the rolling, historically misspelled ``lastest_{DN,DP,NN,NP}_ema.ckpt``;
the trainer's state (optimizers, step, EMA) in ``{iter}.state``.
Trees are nested dicts of arrays in flax's layout (``utils/convert.py``
turns them into the port's parameters). ``load_pytree`` needs no template:
it returns the file's tree as written."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import msgpack


def _host_tree(tree):
    """The tree with every dict's keys sorted, as the JAX package's
    ``save_pytree`` writes it (``jax.tree.map`` rebuilds dicts in sorted key
    order), so both packages write the same bytes for the same weights."""
    if isinstance(tree, dict):
        return {k: _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_pytree(tree: Any, path: str) -> int:
    """Write ``tree`` (numpy arrays or tensors) as flax msgpack; returns the
    bytes written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack.to_bytes(_host_tree(tree))
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_pytree(path: str):
    """The tree a flax msgpack file holds (nested dicts of numpy arrays)."""
    with open(path, "rb") as f:
        return msgpack.from_bytes(f.read())


def split_smm(params: Dict) -> tuple:
    """(the net without its prompts, the prompts): the DN/DP (NN/NP) split."""
    inner = params["params"] if "params" in params else params
    net = {k: v for k, v in inner.items() if not k.startswith("smm_")}
    prompts = {k: v for k, v in inner.items() if k.startswith("smm_")}
    return net, prompts


def merge_smm(net: Dict, prompts: Dict) -> Dict:
    return {"params": {**net, **prompts}}


def save_bundle(models_dir: str, iteration, drift_params, noise_params,
                drift_ema=None, noise_ema=None) -> int:
    """Write one iteration's bundle; returns the bytes written."""
    n = 0
    dn, dp = split_smm(drift_params)
    nn_, np_ = split_smm(noise_params)
    n += save_pytree(dn, os.path.join(models_dir, f"{iteration}_DN.ckpt"))
    n += save_pytree(nn_, os.path.join(models_dir, f"{iteration}_NN.ckpt"))
    if dp:
        n += save_pytree(dp, os.path.join(models_dir, f"{iteration}_DP.ckpt"))
    if np_:
        n += save_pytree(np_, os.path.join(models_dir, f"{iteration}_NP.ckpt"))
    # the EMA shadows overwrite the rolling 'lastest' files (sic)
    for ema, (net_name, prompt_name) in ((drift_ema, ("DN", "DP")), (noise_ema, ("NN", "NP"))):
        if ema is None:
            continue
        net, prompts = split_smm(ema)
        n += save_pytree(net, os.path.join(models_dir, f"lastest_{net_name}_ema.ckpt"))
        if prompts:
            n += save_pytree(prompts, os.path.join(models_dir, f"lastest_{prompt_name}_ema.ckpt"))
    return n


def load_bundle(models_dir: str, iteration, use_ema: bool = False) -> tuple:
    """(drift net, drift prompts, noise net, noise prompts) of one bundle:
    the iteration's files, or the EMA shadows with ``use_ema``. A prompt file
    that is absent gives None (the JAX loader keeps its template's prompts
    then); an absent net file raises ``FileNotFoundError``."""
    def path(kind):
        return os.path.join(models_dir, f"lastest_{kind}_ema.ckpt" if use_ema
                            else f"{iteration}_{kind}.ckpt")

    def optional(kind) -> Optional[Dict]:
        return load_pytree(path(kind)) if os.path.isfile(path(kind)) else None

    return load_pytree(path("DN")), optional("DP"), load_pytree(path("NN")), optional("NP")


def save_training_state(state_dir: str, iteration, epoch, opt_states: Dict,
                        extra: Optional[Dict] = None) -> int:
    """``{iter}.state``: ``{"epoch", "iter", "opt": opt_states, "extra"}``,
    epoch and iter as the 0-d int64 arrays the JAX package's ``save_pytree``
    makes of them, so both write the same bytes for the same state; returns
    the bytes written."""
    tree = {"epoch": np.asarray(int(epoch), np.int64), "iter": np.asarray(int(iteration), np.int64),
            "opt": opt_states, "extra": extra or {}}
    return save_pytree(tree, os.path.join(state_dir, f"{iteration}.state"))


def load_training_state(path: str) -> Dict:
    """The tree of a ``{iter}.state`` file, epoch and iter as python ints."""
    tree = load_pytree(path)
    tree["epoch"], tree["iter"] = int(tree["epoch"]), int(tree["iter"])
    return tree
