"""The sampling half of ``CLIPDriftEngine`` (port of
``instancediff_tpu/models/drift_model.py``: ``build_sample_fn`` and ``test``).

The engine owns the frozen CLIP text tower, the prompt ids and the dual UNets
(drift and noise net, raw and EMA weights, as the JAX engine's ``state``
keys name them); ``engine.SamplingEngine`` holds what it shares with the
DDPM engine (``ddpm_model.py``), the sampler call ``test`` among it. A
sampler call encodes the prompts with each net's per-scale SMM contexts
once, outside the step loop, then runs the two nets one after the other at
every step of ``DriftSDE.step``: eagerly, or replayed from a CUDA graph."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..sde.drift_sde import DriftSDE
from .engine import ARTIFACT_PROMPTS, SamplingEngine

OPTIMIZE_TYPES = ("inputRes", "predict_noise", "", "predict_std_noise_scale_drift",
                  "predict_x0")
NET_KEYS = ("drift", "noise", "d_ema", "n_ema")


class CLIPDriftEngine(SamplingEngine):
    """Sampling engine. ``dnet_settings``/``nnet_settings`` are the
    ``models.DriftNoise`` settings blocks (``bench.py``'s flagship: nf 64,
    ch_mult [1,2,4,4], 2 ResBlocks per level); ``dtype`` is the compute dtype
    of the nets and the text tower (norm statistics stay float32).
    ``engine_opts={"fused_gnconv": False}`` runs the unfused ResBlock body
    and head (default True: the fused body); see ``engine.SamplingEngine`` for the
    other knobs. With ``use_degra_context`` the context gains a second token,
    the prompt's text encoding without learnable context, and the ResBlocks
    run the unfused body with full cross-attention.
    Parameters start at PyTorch's default init; load trained or reference
    weights with ``utils.convert.load_engine``."""

    def __init__(self, dnet_settings: Dict, nnet_settings: Dict,
                 optimize_type: str = "inputRes", optimize_target: str = "std",
                 if_MultiScoreMap: bool = True, score_map_ch_mult=(1, 1, 2, 4),
                 score_map_ngf: int = 64, use_image_context: bool = True,
                 use_degra_context: bool = False, CLIP_Type: str = "CLIP",
                 artifact_prompts: Sequence[str] = ARTIFACT_PROMPTS,
                 type_map_ind: Optional[Dict[str, int]] = None,
                 sde: Optional[DriftSDE] = None, dtype: torch.dtype = torch.float32,
                 tokenizer_vocab_path: Optional[str] = None,
                 tiny_text_encoder: bool = False, engine_opts: Optional[Dict] = None,
                 device="cuda"):
        super().__init__(dict(dnet_settings).get("context_dim", 512), CLIP_Type,
                         artifact_prompts, type_map_ind, engine_opts, dtype,
                         tokenizer_vocab_path, tiny_text_encoder, device)
        if optimize_type not in OPTIMIZE_TYPES:
            raise ValueError(f"optimize_type {optimize_type!r} cannot be sampled; "
                             f"choose from {OPTIMIZE_TYPES}")
        if optimize_target != "std":
            raise ValueError(f"optimize_target {optimize_target!r} is not supported "
                             "(only 'std')")
        self.optimize_type = optimize_type
        self.use_image_context = use_image_context
        self.use_degra_context = use_degra_context
        self.sde = sde
        fused = bool(self.engine_opts.get("fused_gnconv", True))

        def build_unet(s):
            return self._build_unet(
                s, if_MultiScoreMap=dict(s).get("if_MultiScoreMap", if_MultiScoreMap),
                score_map_ch_mult=tuple(score_map_ch_mult), score_map_ngf=score_map_ngf,
                use_image_context=use_image_context, use_degra_context=use_degra_context,
                use_fused_gnconv=fused)

        settings = {"drift": dnet_settings, "noise": nnet_settings,
                    "d_ema": dnet_settings, "n_ema": nnet_settings}
        self.nets = nn.ModuleDict({k: build_unet(settings[k]) for k in NET_KEYS})

    def _net_inputs(self, x, mu):
        """(x_a, x_b) of the drift net and of the noise net."""
        if self.optimize_type in ("inputRes", "predict_noise", ""):
            return (x - mu, mu), (x - mu, x)
        return (x, mu), (x, mu)

    def _to_drift_eps(self, x, row, pd_raw, pn_raw):
        """Raw net outputs -> (full drift D_hat, eps_hat) for the step whose
        coefficient row is ``row`` (``DriftSDE.COLUMNS``)."""
        if self.optimize_type in ("inputRes", "predict_noise", ""):
            return pd_raw, pn_raw
        _, _, sd, _, sig, _, _ = row.unbind()
        if self.optimize_type == "predict_std_noise_scale_drift":
            return pd_raw.to(x.dtype) / torch.clamp(sd, min=1e-6), pn_raw
        # predict_x0: the noise net emits x0 directly
        d_full = pd_raw.to(x.dtype)
        eps_hat = (x - pn_raw.to(x.dtype) - sd * d_full) / torch.clamp(sig, min=1e-6)
        return d_full, eps_hat

    def _step_nets(self, use_ema: bool):
        return (self.nets["d_ema" if use_ema else "drift"],
                self.nets["n_ema" if use_ema else "noise"])

    def _inputs(self, batch, use_ema: bool):
        """The call's tensors: mu, type ids, the image context and (with
        ``use_degra_context``) the prompt's encoding without learnable
        context as one token, and each net's per-SMM text encodings."""
        mu = self._tensor(batch["input"], torch.float32)
        type_idx = self._tensor(batch["type_idx"], torch.int64)
        degra_ctx = None
        if self.use_degra_context:
            degra_ctx = self.text_encoder(self.prompt_ids, None)[type_idx][:, None, :]
        dnet, nnet = self._step_nets(use_ema)
        return {"mu": mu, "type_idx": type_idx, "img_ctx": self._image_context(batch, mu.shape[0]),
                "degra_ctx": degra_ctx, "d_text": self._encode_prompts(dnet),
                "n_text": self._encode_prompts(nnet)}

    def _predictor(self, inputs, use_ema: bool):
        """``predict(x, row)``: the drift net, then the noise net, at the
        row's timestep, reading the call's tensors from ``inputs``."""
        dnet, nnet = self._step_nets(use_ema)
        mu, type_idx = inputs["mu"], inputs["type_idx"]
        img_ctx, degra_ctx = inputs["img_ctx"], inputs["degra_ctx"]
        B = mu.shape[0]

        def predict(x, row):
            t_b = row[0].to(torch.int32).expand(B)
            d_in, n_in = self._net_inputs(x, mu)
            pd, _ = dnet(d_in[0], d_in[1], t_b, type_idx, inputs["d_text"], img_ctx, degra_ctx)
            pn, _ = nnet(n_in[0], n_in[1], t_b, type_idx, inputs["n_text"], img_ctx, degra_ctx)
            return self._to_drift_eps(x, row, pd, pn)

        return predict
