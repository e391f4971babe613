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

    @torch.inference_mode()
    def test(self, batch, generator: Optional[torch.Generator] = None, use_ema: bool = True,
             sample_steps: Optional[int] = None, eta: Optional[float] = None,
             init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Restore a batch: ``batch["input"]`` [B,H,W,1] in [-1,1] (the
        condition mu), ``batch["type_idx"]`` [B], optional ``batch["A_emb"]``
        [B,1,context_dim] (zeros when absent; used with image context).
        Returns x0_hat [B,H,W,1] float32 on the engine's device. Noise comes
        from ``generator`` unless ``init_noise`` and ``step_noise`` are given
        (see ``DDPMSDE.reverse_ddpm``)."""
        if self.sde is None:
            raise ValueError("engine has no SDE; pass sde= to the constructor")
        mu = self._tensor(batch["input"], torch.float32)
        type_idx = self._tensor(batch["type_idx"], torch.int64)
        B = mu.shape[0]
        img_ctx = self._image_context(batch, B)
        net = self.nets["n_ema" if use_ema else "noise"]
        text = self._encode_prompts(net)

        def predict(x, t: int):
            t_b = torch.full((B,), t, dtype=torch.int32, device=self.device)
            return net(x, mu, t_b, type_idx, text, img_ctx)[0]

        return self.sde.reverse_ddpm(mu, predict, sample_steps=sample_steps, eta=eta,
                                     generator=generator, init_noise=init_noise,
                                     step_noise=step_noise)
