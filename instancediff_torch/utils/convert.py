"""Convert the JAX package's parameter trees into the port's modules
(``load_flax_params``) and back (``flax_params``).

The trees are nested dicts of numpy arrays, as ``engine.state["d_ema"]``,
``engine.state["n_ema"]`` and ``engine.text_params`` hold them (an optional
top-level ``"params"`` collection is unwrapped). Module names match one to
one; leaves are renamed and re-laid-out by the kind of torch module that owns
them:

- ``nn.Linear``: Dense ``kernel [in, out]`` -> ``weight = kernel.T``;
- ``nn.Conv2d``: conv ``kernel`` HWIO -> OIHW;
- ``nn.ConvTranspose2d``: flax ``ConvTranspose`` correlates with the
  unflipped kernel while torch's transposed conv flips it, so the kernel is
  flipped in H and W, then laid out ``[in, out, kh, kw]``;
- ``ConvParams`` (the fused conv's parameters): ``kernel`` kept HWIO;
- ``nn.Embedding``: ``embedding`` -> ``weight``;
- norms: ``scale`` -> ``weight``;
- free parameters (SMM ``context``, ``gamma1/2``, ``logit_scale``,
  ``score_bias``, ``positional_embedding``) as they are.

Every leaf of the tree must be consumed and every parameter of the module
filled; a leftover or a missing key raises."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import ConvParams

# torch submodule names that differ from the flax module names
_FLAX_MODULE_NAME = {"norm": "GroupNorm_0", "ln": "LayerNorm_0"}


def _flatten(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = (v.float().numpy() if isinstance(v, torch.Tensor)
                                       else np.asarray(v))
    return out


def _leaf(owner: nn.Module, pname: str):
    """(flax leaf name, flax -> torch layout, torch -> flax layout) for
    parameter ``pname`` of ``owner``; the two transforms are inverses."""
    if pname != "weight":
        return pname, _same, _same
    if isinstance(owner, nn.Linear):
        return "kernel", _transpose, _transpose
    if isinstance(owner, nn.ConvTranspose2d):
        return ("kernel", lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
                lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1])
    if isinstance(owner, nn.Conv2d):
        return "kernel", lambda a: a.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0)
    if isinstance(owner, ConvParams):
        return "kernel", _same, _same
    if isinstance(owner, nn.Embedding):
        return "embedding", _same, _same
    return "scale", _same, _same  # GroupNorm / LayerNorm / FusedGroupNormSiLU


def _same(a):
    return a


def _transpose(a):
    return a.T


def _flax_key(module_path, owner, pname) -> tuple:
    return tuple(_FLAX_MODULE_NAME.get(p, p) for p in module_path) + (_leaf(owner, pname)[0],)


def load_flax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place (keeping each
    parameter's dtype and device); returns the module."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = _flatten(tree)
    used = set()
    modules = dict(module.named_modules())
    with torch.no_grad():
        for name, param in module.named_parameters():
            *mod_path, pname = name.split(".")
            owner = modules[".".join(mod_path)]
            key = _flax_key(mod_path, owner, pname)
            transform = _leaf(owner, pname)[1]
            if key not in flat:
                raise KeyError(f"flax tree has no leaf {'/'.join(key)} for "
                               f"parameter {name}")
            value = np.array(transform(flat[key]), dtype=np.float32, order="C")
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: flax {'/'.join(key)} gives shape "
                                 f"{value.shape}, parameter is {tuple(param.shape)}")
            param.copy_(torch.from_numpy(value))
            used.add(key)
    leftover = sorted("/".join(k) for k in set(flat) - used)
    if leftover:
        raise KeyError(f"flax leaves not consumed by {type(module).__name__}: "
                       f"{leftover[:10]}{' ...' if len(leftover) > 10 else ''}")
    return module


def flax_params(module: nn.Module) -> Dict:
    """``module``'s parameters as a flax tree ``{"params": {...}}`` of float32
    numpy arrays: the inverse of :func:`load_flax_params`."""
    tree: Dict = {}
    modules = dict(module.named_modules())
    for name, param in module.named_parameters():
        *mod_path, pname = name.split(".")
        owner = modules[".".join(mod_path)]
        *parents, leaf = _flax_key(mod_path, owner, pname)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        value = param.detach().float().cpu().numpy()
        node[leaf] = np.array(_leaf(owner, pname)[2](value), order="C")
    return {"params": tree}


def load_engine(engine, state, text_params):
    """Fill a port engine from the JAX engine's ``state`` (keys drift / noise
    / d_ema / n_ema for ``CLIPDriftEngine``, noise / n_ema for
    ``CLIPDDPMEngine``) and ``text_params``."""
    for key, net in engine.nets.items():
        load_flax_params(net, state[key])
    load_flax_params(engine.text_encoder, text_params)
    return engine
