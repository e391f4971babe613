"""``CLIPDDPMEngine``, the conditional-DDPM baseline (port of
``instancediff_tpu/models/ddpm_model.py``: the train step
``build_train_step``/``optimize_parameters``, ``build_sample_fn``, ``test``,
``load``, ``save``, the training state and the factory
``create_CLIPDDPMModel``).

One noise net, the single-score-map UNet (``if_MultiScoreMap=False``), raw
and EMA weights under the JAX engine's ``state`` keys ``noise`` / ``n_ema``.
It sees ``(x_t, mu)`` and predicts the injected noise (the train step's loss:
the noise's mean squared error plus the score-map loss); ``DDPMSDE`` samples
from pure noise. The JAX sampler sets neither ``fused_gnconv`` nor
``pallas_gn``, so every ResBlock runs the unfused body: here on the
GroupNorm + SiLU kernel."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..sde.ddpm_sde import DDPMSDE
from ..utils import checkpoint as ckpt
from ..utils.convert import flax_params, load_flax_params
from .engine import ARTIFACT_PROMPTS, SamplingEngine, factory_kwargs, score_map_loss

NET_KEYS = ("noise", "n_ema")


class CLIPDDPMEngine(SamplingEngine):
    """Training and sampling engine. ``net_settings`` is the ``models.DDPM`` settings
    block (``Configurations/flagship_ddpm_tpu.yml``: nf 64, ch_mult
    [1,2,4,4], 2 ResBlocks per level, ``score_map_ngf`` 64 by default);
    ``dtype`` is the compute dtype of the net and the text tower. Every
    ``engine_opts`` knob is accepted and changes nothing (see
    ``engine.SamplingEngine``). As in the JAX engine, the net gets no
    degradation token, in training or sampling, even with
    ``use_degra_context``. ``if_train`` and the optimizer's arguments are
    those of ``drift_model.CLIPDriftEngine``, for the one net. A sampling
    engine's parameters start at PyTorch's default init; load a bundle with
    ``load`` or a JAX engine's weights with ``utils.convert.load_engine``."""

    TRAINED = {"noise": ("n_opt", "n_ema")}

    def __init__(self, net_settings: Dict, noise_net_lr: float = 2e-5,
                 weight_decay: float = 1e-4, beta1: float = 0.9, beta2: float = 0.99,
                 nepoch: int = 500, eta_min: float = 1e-6, use_image_context: bool = True,
                 use_degra_context: bool = False, CLIP_Type: str = "CLIP",
                 artifact_prompts: Sequence[str] = ARTIFACT_PROMPTS,
                 type_map_ind: Optional[Dict[str, int]] = None,
                 sde: Optional[DDPMSDE] = None, dtype: torch.dtype = torch.float32,
                 tokenizer_vocab_path: Optional[str] = None,
                 tiny_text_encoder: bool = False, engine_opts: Optional[Dict] = None,
                 text_encoder_pretrain_path: Optional[str] = None, device="cuda",
                 if_train: bool = False, image_size: int = 224, remat="auto",
                 degrade_on_device: bool = False, seed: int = 0):
        settings = dict(net_settings)
        super().__init__(settings.get("context_dim", 512), CLIP_Type, artifact_prompts,
                         type_map_ind, engine_opts, dtype, tokenizer_vocab_path,
                         tiny_text_encoder, device, text_encoder_pretrain_path, if_train)
        self.use_image_context = use_image_context
        self.degrade_on_device = bool(degrade_on_device)
        self.sde = sde
        self.nets = nn.ModuleDict({k: self._build_unet(
            settings, if_MultiScoreMap=False,
            score_map_ngf=settings.get("score_map_ngf", 64),
            use_image_context=use_image_context, use_degra_context=use_degra_context,
            use_fused_gnconv=False) for k in NET_KEYS})
        self._init_training({"noise": noise_net_lr}, beta1, beta2, weight_decay, nepoch,
                            eta_min, image_size, remat, seed)

    def _load_nets(self, models_dir: str, iteration, load_ema: bool) -> None:
        """The JAX engine's ``load``: ``{iter}_NN`` (and ``{iter}_NP``, else the
        net keeps its prompts), then ``lastest_NN_ema`` (and its prompts, else
        the online net's prompts from before this load), or a copy of the
        online net without it."""
        np_t = ckpt.split_smm(flax_params(self.nets["noise"]))[1]

        def read(path, prompt_path):
            net = ckpt.load_pytree(path)
            prompts = (ckpt.load_pytree(prompt_path) if np_t and os.path.isfile(prompt_path)
                       else np_t)
            return ckpt.merge_smm(net, prompts)

        load_flax_params(self.nets["noise"], read(f"{models_dir}/{iteration}_NN.ckpt",
                                                  f"{models_dir}/{iteration}_NP.ckpt"))
        if not load_ema:
            return
        ema_path = f"{models_dir}/lastest_NN_ema.ckpt"
        if os.path.isfile(ema_path):
            load_flax_params(self.nets["n_ema"],
                             read(ema_path, f"{models_dir}/lastest_NP_ema.ckpt"))
        else:
            self.nets["n_ema"].load_state_dict(self.nets["noise"].state_dict())

    def _save_nets(self, models_dir: str, iteration) -> int:
        """``{iter}_NN`` (``{iter}_NP``) and ``lastest_NN_ema`` (``lastest_NP_ema``)."""
        n = 0
        for key, net_name, prompt_name in (
                ("noise", f"{iteration}_NN", f"{iteration}_NP"),
                ("n_ema", "lastest_NN_ema", "lastest_NP_ema")):
            net, prompts = ckpt.split_smm(flax_params(self.nets[key]))
            n += ckpt.save_pytree(net, f"{models_dir}/{net_name}.ckpt")
            if prompts:
                n += ckpt.save_pytree(prompts, f"{models_dir}/{prompt_name}.ckpt")
        return n

    def _loss_keys(self) -> tuple:
        return ("l", "nl", "nsml")

    def _train_loss(self, batch, generator, t, std_noise, deg_noise):
        """The JAX engine's train-step loss: the net on (x_t, mu) against the
        injected noise, plus its score-map pyramid loss."""
        mu, x0, type_idx, img_ctx = self._train_batch(batch, generator, deg_noise)
        t, x_t, eps = self.sde.forward_diffusion(x0, mu, generator, t, std_noise)
        net = self.nets["noise"]
        pred, sms = net(x_t, mu, t.reshape(-1), type_idx, self._encode_prompts(net), img_ctx,
                        plain=True)
        nloss = torch.mean((pred - eps) ** 2)
        sml = score_map_loss(sms, eps) if sms else torch.zeros((), device=self.device)
        loss = nloss + sml
        return loss, {"l": loss, "nl": nloss, "nsml": sml}

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


def create_CLIPDDPMModel(train_opt, model_opt, phase="train", **kwargs) -> CLIPDDPMEngine:
    """The engine of a ``models.DDPM`` option block, read with the JAX
    factory's defaults (``create_CLIPDDPMModel`` in
    ``instancediff_tpu/models/ddpm_model.py``); see
    ``drift_model.create_CLIPDriftModel``."""
    return CLIPDDPMEngine(net_settings=dict(model_opt["net_settings"]),
                          noise_net_lr=model_opt.get("noise_net_lr", 2e-5),
                          weight_decay=model_opt.get("weight_decay", 1e-4),
                          nepoch=(train_opt or {}).get("nepoch", 500),
                          **factory_kwargs(model_opt, kwargs, phase))
