"""SigLIP / big_vision checkpoint loading (port of
``instancediff_tpu/models/big_vision.py``): map a Google big_vision ``.npz``
image tower (``params/img/...``, flax layouts: Dense kernels [in, out],
the patch conv [P, P, 3, width], fused-head attention kernels) onto the
port's ``clip_vit.CLIPVisionTower``. SigLIP's ViT has no class token and
pools with a MAP head; the tower pools its class token, so the loader maps
the backbone (patch embedding, position table, encoder blocks, final norm)
and reports what it skipped.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .clip_vit import CLIPVisionTower
from .pos_embed import interpolate_pos_embed

__all__ = ["load_big_vision_weights"]


def _mha_kernel(w, key) -> np.ndarray:
    """A big_vision q/k/v kernel [width, heads, head_dim] as [width, width]."""
    a = np.asarray(w[key])
    return a.reshape(a.shape[0], -1) if a.ndim == 3 else a.reshape(-1, a.shape[-1])


def load_big_vision_weights(tower: CLIPVisionTower, checkpoint_path: str,
                            prefix: str = "params/img/") -> Tuple[CLIPVisionTower, List[str]]:
    """Fill ``tower`` in place from a big_vision ``.npz``. A cls-free
    position table keeps the tower's class row; a grid of another size is
    resampled by JAX's cubic resize (``pos_embed.interpolate_pos_embed``).
    Returns ``(tower, skipped)``; raises KeyError when the backbone's keys
    are absent (not a big_vision checkpoint, or another ``prefix``)."""
    w = np.load(checkpoint_path)
    skipped = []
    k = f"{prefix}embedding/kernel"
    if k not in w:
        raise KeyError(f"{k} not in {checkpoint_path}: not a big_vision checkpoint or wrong "
                       f"prefix {prefix!r}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))

    def put(param, value):
        value = t(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"checkpoint gives shape {tuple(value.shape)} for a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    def dense(lin, kernel, bias):
        put(lin.weight, np.asarray(kernel).T)
        put(lin.bias, np.asarray(bias).reshape(-1))

    with torch.no_grad():
        put(tower.patch_embed.weight, np.asarray(w[k]).transpose(3, 2, 0, 1))
        put(tower.patch_embed.bias, w[f"{prefix}embedding/bias"])
        src = np.asarray(w[f"{prefix}pos_embedding"])
        pos = src.reshape(-1, src.shape[-1])
        n_dst = tower.pos_embed.shape[0]
        if pos.shape[0] not in (n_dst, n_dst - 1):
            pos = interpolate_pos_embed(pos, n_dst - 1, n_prefix=0).numpy()
            skipped.append(f"pos grid resampled {src.size // pos.shape[-1]}->{n_dst - 1} tokens")
        if pos.shape[0] == n_dst - 1:
            pos = np.concatenate([tower.pos_embed[:1].detach().cpu().numpy(), pos], axis=0)
            skipped.append("cls pos (source has none)")
        put(tower.pos_embed, pos)
        if f"{prefix}cls" in w:
            put(tower.class_token, np.asarray(w[f"{prefix}cls"]).reshape(1, 1, -1))
        else:
            skipped.append("class_token (SigLIP is cls-free; kept random)")
        for i in range(tower.layers):
            bp = f"{prefix}Transformer/encoderblock_{i}/"
            mha = bp + "MultiHeadDotProductAttention_0/"
            blk = getattr(tower, f"block_{i}")
            put(blk.ln_1.weight, w[f"{bp}LayerNorm_0/scale"])
            put(blk.ln_1.bias, w[f"{bp}LayerNorm_0/bias"])
            for lin, name in ((blk.q_proj, "query"), (blk.k_proj, "key"),
                              (blk.v_proj, "value")):
                dense(lin, _mha_kernel(w, f"{mha}{name}/kernel"), w[f"{mha}{name}/bias"])
            out_k = np.asarray(w[f"{mha}out/kernel"])  # [heads, head_dim, width]
            dense(blk.out_proj, out_k.reshape(-1, out_k.shape[-1]), w[f"{mha}out/bias"])
            put(blk.ln_2.weight, w[f"{bp}LayerNorm_1/scale"])
            put(blk.ln_2.bias, w[f"{bp}LayerNorm_1/bias"])
            dense(blk.fc, w[f"{bp}MlpBlock_0/Dense_0/kernel"], w[f"{bp}MlpBlock_0/Dense_0/bias"])
            dense(blk.proj, w[f"{bp}MlpBlock_0/Dense_1/kernel"],
                  w[f"{bp}MlpBlock_0/Dense_1/bias"])
        put(tower.ln_post.weight, w[f"{prefix}Transformer/encoder_norm/scale"])
        put(tower.ln_post.bias, w[f"{prefix}Transformer/encoder_norm/bias"])
    if f"{prefix}MAPHead_0/probe" in w:
        skipped.append("MAPHead attention pool (tower pools the cls token)")
    skipped.append("proj (no big_vision counterpart on the image trunk)")
    return tower, skipped
