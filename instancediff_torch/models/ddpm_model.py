"""The sampling half of ``CLIPDDPMEngine``, the conditional-DDPM baseline
(port of ``instancediff_tpu/models/ddpm_model.py``: ``build_sample_fn`` and
``test``).

One noise net, the single-score-map UNet (``if_MultiScoreMap=False``), raw
and EMA weights under the JAX engine's ``state`` keys ``noise`` / ``n_ema``.
It sees ``(x_t, mu)`` and predicts the injected noise; ``DDPMSDE`` samples
from pure noise. The JAX sampler sets neither ``fused_gnconv`` nor
``pallas_gn``, so every ResBlock runs the unfused body: here on the
GroupNorm + SiLU kernel."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..sde.ddpm_sde import DDPMSDE
from .engine import ARTIFACT_PROMPTS, SamplingEngine

NET_KEYS = ("noise", "n_ema")


class CLIPDDPMEngine(SamplingEngine):
    """Sampling engine. ``net_settings`` is the ``models.DDPM`` settings
    block (``Configurations/flagship_ddpm_tpu.yml``: nf 64, ch_mult
    [1,2,4,4], 2 ResBlocks per level, ``score_map_ngf`` 64 by default);
    ``dtype`` is the compute dtype of the net and the text tower. Every
    ``engine_opts`` knob is accepted and changes nothing (see
    ``engine.SamplingEngine``). As in the JAX sampler, the net gets no degradation
    token at sampling time, even with ``use_degra_context``.
    Parameters start at PyTorch's default init; load trained or reference
    weights with ``utils.convert.load_engine``."""

    def __init__(self, net_settings: Dict, use_image_context: bool = True,
                 use_degra_context: bool = False, CLIP_Type: str = "CLIP",
                 artifact_prompts: Sequence[str] = ARTIFACT_PROMPTS,
                 type_map_ind: Optional[Dict[str, int]] = None,
                 sde: Optional[DDPMSDE] = None, dtype: torch.dtype = torch.float32,
                 tokenizer_vocab_path: Optional[str] = None,
                 tiny_text_encoder: bool = False, engine_opts: Optional[Dict] = None,
                 device="cuda"):
        settings = dict(net_settings)
        super().__init__(settings.get("context_dim", 512), CLIP_Type, artifact_prompts,
                         type_map_ind, engine_opts, dtype, tokenizer_vocab_path,
                         tiny_text_encoder, device)
        self.use_image_context = use_image_context
        self.sde = sde
        self.nets = nn.ModuleDict({k: self._build_unet(
            settings, if_MultiScoreMap=False,
            score_map_ngf=settings.get("score_map_ngf", 64),
            use_image_context=use_image_context, use_degra_context=use_degra_context,
            use_fused_gnconv=False) for k in NET_KEYS})

    def _step_nets(self, use_ema: bool):
        return (self.nets["n_ema" if use_ema else "noise"],)

    def _inputs(self, batch, use_ema: bool):
        """The call's tensors: mu (the condition), type ids, the image
        context and the net's text encoding."""
        mu = self._tensor(batch["input"], torch.float32)
        return {"mu": mu, "type_idx": self._tensor(batch["type_idx"], torch.int64),
                "img_ctx": self._image_context(batch, mu.shape[0]),
                "text": self._encode_prompts(self._step_nets(use_ema)[0])}

    def _predictor(self, inputs, use_ema: bool):
        """``predict(x, row)``: the noise net at the row's timestep, reading
        the call's tensors from ``inputs``."""
        net, = self._step_nets(use_ema)
        mu, type_idx, img_ctx = inputs["mu"], inputs["type_idx"], inputs["img_ctx"]
        B = mu.shape[0]

        def predict(x, row):
            t_b = row[0].to(torch.int32).expand(B)
            return net(x, mu, t_b, type_idx, inputs["text"], img_ctx)[0]

        return predict
