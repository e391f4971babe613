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
  ``score_bias``, ``positional_embedding``; the image tower's
  ``class_token``, ``pos_embed`` and LayerScale ``ls_1``/``ls_2``; the BERT
  tower's ``position_embeddings`` and ``token_type_embeddings``) as they are.

So the towers' trees map with no table of their own: the image tower
(``models/clip_vit.py``) ``patch_embed.kernel`` [P,P,3,W] <-> the patch
conv's weight [W,3,P,P], ``block_{i}``, ``ln_pre``/``ln_post``, ``proj``;
the BERT tower (``text_encoder.HFContextTextEncoder``)
``word_embeddings.embedding``, ``embeddings_ln``, ``layer_{i}.{q,k,v,out}_proj``,
``attn_ln``, ``fc``, ``proj``, ``ffn_ln``, ``proj_fc1``/``proj_fc2``; the
tower breadth (``models/vision_towers.py``): ``FrozenBatchNorm``'s free
``scale``/``bias``/``mean``/``var``, the ResNets' bias-free convs HWIO <->
OIHW, the attention pool's ``positional_embedding``, the dense ViT's
``class_embedding``, ``positional_embedding`` and ``proj`` [width, out]
(free), its necks' GroupNorms (``scale``) and flax ``ConvTranspose``
kernels (flipped, as above), the decoders' Dense layers and
``RefDecoderLayer``'s ``gamma_*``.

Every leaf of the tree must be consumed and every parameter of the module
filled; a leftover or a missing key raises. Adam's moments are trees of the
same layout: ``adam_state``/``load_adam_state`` map a ``torch.optim.Adam``
to and from the flax state dict of the JAX engines' optax optimizer, and
``load_engine``/``engine_state`` carry a JAX engine's whole ``state``
(nets, EMA shadows, optimizer states, step) across."""

from __future__ import annotations

from typing import Dict, Optional

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


def torch_values(module: nn.Module, tree) -> Dict[str, np.ndarray]:
    """{parameter name: float32 array in the torch layout} for a flax tree
    laid out like ``module``'s parameters (an Adam moment tree too). Every
    leaf must be consumed and every parameter found; else it raises."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = _flatten(tree)
    used = set()
    out = {}
    modules = dict(module.named_modules())
    for name, param in module.named_parameters():
        *mod_path, pname = name.split(".")
        owner = modules[".".join(mod_path)]
        key = _flax_key(mod_path, owner, pname)
        if key not in flat:
            raise KeyError(f"flax tree has no leaf {'/'.join(key)} for parameter {name}")
        value = np.array(_leaf(owner, pname)[1](flat[key]), dtype=np.float32, order="C")
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: flax {'/'.join(key)} gives shape "
                             f"{value.shape}, parameter is {tuple(param.shape)}")
        out[name] = value
        used.add(key)
    leftover = sorted("/".join(k) for k in set(flat) - used)
    if leftover:
        raise KeyError(f"flax leaves not consumed by {type(module).__name__}: "
                       f"{leftover[:10]}{' ...' if len(leftover) > 10 else ''}")
    return out


def load_flax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a flax parameter tree into ``module`` in place (keeping each
    parameter's dtype and device); returns the module."""
    values = torch_values(module, tree)
    with torch.no_grad():
        for name, param in module.named_parameters():
            param.copy_(torch.from_numpy(values[name]))
    return module


def flax_params(module: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """``module``'s parameters as a flax tree ``{"params": {...}}`` of float32
    numpy arrays: the inverse of :func:`load_flax_params`. ``tensors``
    ({parameter name: tensor like it}, e.g. Adam's moments) are laid out
    in their parameters' places instead."""
    tree: Dict = {}
    modules = dict(module.named_modules())
    for name, param in module.named_parameters():
        *mod_path, pname = name.split(".")
        owner = modules[".".join(mod_path)]
        *parents, leaf = _flax_key(mod_path, owner, pname)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        value = (param if tensors is None else tensors[name]).detach().float().cpu().numpy()
        node[leaf] = np.array(_leaf(owner, pname)[2](value), order="C")
    return {"params": tree}


def adam_state(opt: torch.optim.Adam, net: nn.Module) -> Dict:
    """The state of ``net``'s Adam as the flax state dict of the JAX engines'
    optimizer (``make_adam``: optax's ``inject_hyperparams`` over
    ``chain(add_decayed_weights, scale_by_adam, scale_by_learning_rate)``):
    ``count`` and ``hyperparams.learning_rate``, and ``inner_state`` ``0``
    / ``1`` / ``2`` = empty, ``ScaleByAdamState(count, mu, nu)``, empty.
    ``mu``/``nu`` are torch's ``exp_avg``/``exp_avg_sq`` in the parameters'
    flax layout (zeros before the first step); ``count`` is torch's
    ``step``."""
    params = dict(net.named_parameters())
    steps = {int(opt.state[p]["step"]) for p in params.values() if p in opt.state}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters are at different steps {sorted(steps)}; "
                         "optax keeps one count")
    count = np.asarray(steps.pop() if steps else 0, np.int32)

    def moment(key):
        return flax_params(net, {n: opt.state[p][key] if p in opt.state else torch.zeros_like(p)
                                 for n, p in params.items()})

    return {"count": count,
            "hyperparams": {"learning_rate": np.asarray(opt.param_groups[0]["lr"], np.float32)},
            "hyperparams_states": {},
            "inner_state": {"0": {}, "1": {"count": count, "mu": moment("exp_avg"),
                                           "nu": moment("exp_avg_sq")}, "2": {}}}


def load_adam_state(opt: torch.optim.Adam, net: nn.Module, tree: Dict) -> None:
    """Set ``net``'s Adam from an optax state dict (``adam_state``'s layout,
    as the JAX engines write it): the moments, the step count and the
    learning rate."""
    inner = tree["inner_state"]["1"]
    count = float(np.asarray(inner["count"]))
    mu, nu = torch_values(net, inner["mu"]), torch_values(net, inner["nu"])
    for name, p in net.named_parameters():
        opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                        "exp_avg": torch.from_numpy(mu[name]).to(p.device, p.dtype),
                        "exp_avg_sq": torch.from_numpy(nu[name]).to(p.device, p.dtype)}
    for group in opt.param_groups:
        group["lr"] = float(np.asarray(tree["hyperparams"]["learning_rate"]))


def load_engine(engine, state, text_params=None):
    """Fill a port engine from the JAX engine's ``state`` (keys drift / noise
    / d_ema / n_ema for ``CLIPDriftEngine``, noise / n_ema for
    ``CLIPDDPMEngine``; for an engine that trains also the optimizer states
    d_opt / n_opt and ``step`` where the state has them) and
    ``text_params``."""
    for key, net in engine.nets.items():
        load_flax_params(net, state[key])
    trained = _trained(engine)
    for key, opt_key in trained:
        if opt_key in state:
            load_adam_state(engine.optimizers[key], engine.nets[key],
                            flax_state_dict(state[opt_key]))
    if trained and "step" in state:
        engine.step = int(np.asarray(state["step"]))
    if text_params is not None:
        load_flax_params(engine.text_encoder, text_params)
    return engine


def engine_state(engine) -> Dict:
    """The JAX engine's ``state`` of a port engine, as flax state dicts of
    numpy arrays: the nets' trees and, for an engine that trains, the
    optimizer states and ``step`` (int32)."""
    state = {key: flax_params(net) for key, net in engine.nets.items()}
    for key, opt_key in _trained(engine):
        state[opt_key] = adam_state(engine.optimizers[key], engine.nets[key])
        state["step"] = np.asarray(engine.step, np.int32)
    return state


def _trained(engine) -> list:
    """(net key, optimizer state key) of each net ``engine`` trains; none for
    an engine that only samples."""
    if not getattr(engine, "optimizers", None):
        return []
    return [(key, opt_key) for key, (opt_key, _) in engine.TRAINED.items()]


def flax_state_dict(tree):
    """A tree with named tuples (optax's states) as flax's state dict: dicts
    keyed by field name, other tuples and lists keyed '0', '1', ...; other
    leaves as they are."""
    if hasattr(tree, "_fields"):
        return {f: flax_state_dict(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): flax_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): flax_state_dict(v) for k, v in tree.items()}
    return tree
