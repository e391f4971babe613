"""The sampling half of ``CLIPDriftEngine`` (port of
``instancediff_tpu/models/drift_model.py``: ``build_sample_fn`` and ``test``).

The engine owns the frozen CLIP text tower, the prompt ids and the dual UNets
(drift and noise net, raw and EMA weights, as the JAX engine's ``state``
keys name them). A sampler call encodes the prompts with each net's
per-scale SMM contexts once, outside the step loop, then runs the two nets
one after the other at every step of ``DriftSDE.reverse_ddpm``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..device import resolve_device
from ..sde.drift_sde import DriftSDE
from .layers import cast_compute_
from .text_encoder import build_text_encoder
from .tokenizer import ClipBPETokenizer
from .unet import LearnableForwardUNetMultiScoreMap

ARTIFACT_PROMPTS = (
    "speckle in OCT",
    "speckle in ultra sound",
    "noise in cryo-EM image",
    "noise in low dose CT",
    "Gaussian noise in MRI",
)
OPTIMIZE_TYPES = ("inputRes", "predict_noise", "", "predict_std_noise_scale_drift",
                  "predict_x0")
NET_KEYS = ("drift", "noise", "d_ema", "n_ema")


class CLIPDriftEngine:
    """Sampling engine. ``dnet_settings``/``nnet_settings`` are the
    ``models.DriftNoise`` settings blocks (``bench.py``'s flagship: nf 64,
    ch_mult [1,2,4,4], 2 ResBlocks per level); ``dtype`` is the compute dtype
    of the nets and the text tower (norm statistics stay float32).
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
                 tiny_text_encoder: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if CLIP_Type != "CLIP":
            raise NotImplementedError(f"CLIP_Type {CLIP_Type!r} is not ported "
                                      "(only 'CLIP')")
        if optimize_type not in OPTIMIZE_TYPES:
            raise ValueError(f"optimize_type {optimize_type!r} cannot be sampled; "
                             f"choose from {OPTIMIZE_TYPES}")
        if optimize_target != "std":
            raise ValueError(f"optimize_target {optimize_target!r} is not supported "
                             "(only 'std')")
        if use_degra_context:
            raise NotImplementedError("use_degra_context is not ported")
        self.optimize_type = optimize_type
        self.use_image_context = use_image_context
        self.sde = sde
        self.dtype = dtype
        self.type_map = dict(type_map_ind) if type_map_ind else {
            name: i for i, name in enumerate(artifact_prompts)}
        self.context_dim = dict(dnet_settings).get("context_dim", 512)

        text, token_embed_dim = build_text_encoder(self.context_dim, tiny=tiny_text_encoder)
        tok = ClipBPETokenizer(tokenizer_vocab_path, context_length=text.context_length,
                               vocab_size=text.vocab_size)
        self.prompt_ids = torch.from_numpy(tok(list(artifact_prompts))).to(self.device)
        self.text_encoder = cast_compute_(text.to(self.device), dtype).eval()

        def build_unet(s):
            s = dict(s)
            return LearnableForwardUNetMultiScoreMap(
                in_nc=s.get("in_nc", 2), out_nc=s.get("out_nc", 5), nf=s.get("nf", 64),
                ch_mult=tuple(s.get("ch_mult", (1, 2, 4, 4))),
                context_dim=s.get("context_dim", 512),
                text_module=s.get("text_module", "scoremap"),
                score_map_chan=s.get("score_map_chan", 16),
                if_MultiScoreMap=s.get("if_MultiScoreMap", if_MultiScoreMap),
                score_map_ch_mult=tuple(score_map_ch_mult), score_map_ngf=score_map_ngf,
                use_image_context=use_image_context, token_embed_dim=token_embed_dim,
                num_res_blocks=s.get("num_res_blocks", 2),
                num_prompts=len(artifact_prompts))

        settings = {"drift": dnet_settings, "noise": nnet_settings,
                    "d_ema": dnet_settings, "n_ema": nnet_settings}
        self.nets = nn.ModuleDict({
            k: cast_compute_(build_unet(settings[k]).to(self.device), dtype).eval()
            for k in NET_KEYS})

    def _encode_prompts(self, net) -> list:
        """Per-scale [K, context_dim] text encodings for one net's contexts."""
        return [self.text_encoder(self.prompt_ids, ctx) for ctx in net.smm_contexts()]

    def _net_inputs(self, x, mu):
        """(x_a, x_b) of the drift net and of the noise net."""
        if self.optimize_type in ("inputRes", "predict_noise", ""):
            return (x - mu, mu), (x - mu, x)
        return (x, mu), (x, mu)

    def _to_drift_eps(self, x, t: int, pd_raw, pn_raw):
        """Raw net outputs -> (full drift D_hat, eps_hat) for the step."""
        if self.optimize_type in ("inputRes", "predict_noise", ""):
            return pd_raw, pn_raw
        sd = float(self.sde.drift_schedule[t])
        if self.optimize_type == "predict_std_noise_scale_drift":
            return pd_raw.to(x.dtype) / max(sd, 1e-6), pn_raw
        # predict_x0: the noise net emits x0 directly
        sig = float(self.sde.sigmas[t])
        d_full = pd_raw.to(x.dtype)
        eps_hat = (x - pn_raw.to(x.dtype) - sd * d_full) / max(sig, 1e-6)
        return d_full, eps_hat

    def _tensor(self, value, dtype):
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def test(self, batch, generator: Optional[torch.Generator] = None, use_ema: bool = True,
             sample_steps: Optional[int] = None, eta: Optional[float] = None,
             init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Restore a batch: ``batch["input"]`` [B,H,W,1] in [-1,1],
        ``batch["type_idx"]`` [B], optional ``batch["A_emb"]`` [B,1,context_dim]
        (zeros when absent). Returns x0_hat [B,H,W,1] float32 on the engine's
        device. Noise comes from ``generator`` unless ``init_noise`` and
        ``step_noise`` are given (see ``DriftSDE.reverse_ddpm``)."""
        if self.sde is None:
            raise ValueError("engine has no SDE; pass sde= to the constructor")
        mu = self._tensor(batch["input"], torch.float32)
        type_idx = self._tensor(batch["type_idx"], torch.int64)
        B = mu.shape[0]
        img_ctx = None
        if self.use_image_context:
            a_emb = batch.get("A_emb")
            img_ctx = (torch.zeros(B, 1, self.context_dim, device=self.device)
                       if a_emb is None else self._tensor(a_emb, torch.float32))
        dnet = self.nets["d_ema" if use_ema else "drift"]
        nnet = self.nets["n_ema" if use_ema else "noise"]
        d_text = self._encode_prompts(dnet)
        n_text = self._encode_prompts(nnet)

        def predict(x, t: int):
            t_b = torch.full((B,), t, dtype=torch.int32, device=self.device)
            d_in, n_in = self._net_inputs(x, mu)
            pd, _ = dnet(d_in[0], d_in[1], t_b, type_idx, d_text, img_ctx)
            pn, _ = nnet(n_in[0], n_in[1], t_b, type_idx, n_text, img_ctx)
            return self._to_drift_eps(x, t, pd, pn)

        return self.sde.reverse_ddpm(mu, predict, eta=eta, sample_steps=sample_steps,
                                     generator=generator, init_noise=init_noise,
                                     step_noise=step_noise)
