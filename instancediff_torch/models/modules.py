"""The UNet factory (port of ``create_net`` in
``instancediff_tpu/models/modules.py``): a UNet from a
``dnet_settings``/``nnet_settings`` block, its class named by
``class_name``.

``CLIP_ScoreMapModule`` is taken for the JAX signature and not read: the
score map modules are submodules of the UNet, built from the settings."""

from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import cast_compute_
from .unet import LearnableForwardUNet, LearnableForwardUNetMultiScoreMap

_NET_REGISTRY = {
    "LearnableForwardUNet_MultiScoreMap": LearnableForwardUNetMultiScoreMap,
    "LearnableForwardUNet": LearnableForwardUNet,
    # the legacy network_G name of the reference config (which_model_G)
    "ConditionalUNet": LearnableForwardUNet,
}


def create_net(settings, CLIP_ScoreMapModule=None, token_embed_dim: int = 512,
               dtype: torch.dtype = torch.float32, device="cuda",
               use_fused_gnconv: bool = True):
    """The UNet of a net settings block, with the JAX factory's keys and
    defaults (``if_MultiScoreMap`` defaults to True for the multi-score-map
    class only), on ``device`` and computing in ``dtype`` (its weights cast
    to it); the score maps are five prompts wide, as the engines'.
    ``use_fused_gnconv`` picks the ResBlock body (see ``unet.ResBlock``).
    Raises ``ValueError`` for an unknown ``class_name``."""
    name = settings.get("class_name", "LearnableForwardUNet_MultiScoreMap")
    cls = _NET_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown net class '{name}'")
    net = cls(
        in_nc=settings.get("in_nc", 2),
        out_nc=settings.get("out_nc", 5),
        nf=settings.get("nf", 64),
        ch_mult=tuple(settings.get("ch_mult", (1, 2, 4, 4))),
        context_dim=settings.get("context_dim", 512),
        text_module=settings.get("text_module", "scoremap"),
        score_map_chan=settings.get("score_map_chan", 16),
        if_MultiScoreMap=settings.get("if_MultiScoreMap",
                                      cls is LearnableForwardUNetMultiScoreMap),
        score_map_ch_mult=tuple(settings.get("score_map_ch_mult", (1, 1, 2, 4))),
        score_map_ngf=settings.get("score_map_ngf", 64),
        use_image_context=settings.get("use_image_context", False),
        use_degra_context=settings.get("use_degra_context", False),
        token_embed_dim=token_embed_dim,
        num_res_blocks=settings.get("num_res_blocks", 2),
        use_fused_gnconv=use_fused_gnconv,
    )
    return cast_compute_(net.to(resolve_device(device)), dtype)
