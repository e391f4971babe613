"""``CLIPDriftEngine``, the joint training and sampling of the drift and
noise UNets (port of ``instancediff_tpu/models/drift_model.py``: the train
step ``build_train_step``/``optimize_parameters`` with ``_net_io`` and
``_loss_terms``, ``build_sample_fn``, ``test``, ``load``, ``save``, the
training state and the factory ``create_CLIPDriftModel``).

The engine owns the frozen CLIP text tower, the prompt ids and the dual UNets
(drift and noise net, raw and EMA weights, as the JAX engine's ``state``
keys name them); ``engine.SamplingEngine`` holds what it shares with the
DDPM engine (``ddpm_model.py``), the sampler call ``test`` among it. A
sampler call encodes the prompts with each net's per-scale SMM contexts
once, outside the step loop, then runs the two nets one after the other at
every step of ``DriftSDE.step``: eagerly, or replayed from a CUDA graph. A
train step runs the two nets one after the other on their plain path; the
JAX engine vmaps them over stacked parameters when their settings match
(``fuse_dual_train``), which computes the same values."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..sde.drift_sde import DriftSDE
from ..utils import checkpoint as ckpt
from ..utils.convert import flax_params, load_flax_params
from .engine import ARTIFACT_PROMPTS, SamplingEngine, factory_kwargs, score_map_loss
from .layers import cast_compute_

OPTIMIZE_TYPES = ("inputRes", "predict_noise", "", "predict_std_noise_acc_drift",
                  "predict_std_noise_scale_drift", "predict_x0")
NET_KEYS = ("drift", "noise", "d_ema", "n_ema")


class CLIPDriftEngine(SamplingEngine):
    """Training and sampling engine. ``dnet_settings``/``nnet_settings`` are
    the ``models.DriftNoise`` settings blocks (``bench.py``'s flagship: nf
    64, ch_mult [1,2,4,4], 2 ResBlocks per level); ``dtype`` is the compute
    dtype of the nets and the text tower (norm statistics stay float32).
    ``if_train`` builds the optimizers (Adam with coupled L2 at the
    learning rates, betas and weight decay given, the cosine schedule over
    ``nepoch`` down to ``eta_min``) and the EMA shadows, with float32 master
    weights; ``drift_loss`` ("l2" or "l1"), ``noise_loss`` ("none" or
    "uni"), the settings blocks' ``use_dsm``/``use_nsm`` and
    ``degrade_on_device`` (the input synthesised from the target) shape
    the train step, as in JAX.
    ``engine_opts={"fused_gnconv": False}`` runs the unfused ResBlock body
    and head (default True: the fused body); see ``engine.SamplingEngine`` for the
    other knobs. With ``use_degra_context`` the context gains a second token,
    the prompt's text encoding without learnable context, and the ResBlocks
    run the unfused body with full cross-attention.
    A sampling engine's parameters start at PyTorch's default init; load a
    bundle with ``load`` or a JAX engine's weights (and training state) with
    ``utils.convert.load_engine``."""

    TRAINED = {"drift": ("d_opt", "d_ema"), "noise": ("n_opt", "n_ema")}
    NET_NAMES = ("drift_net", "noise_net")

    def __init__(self, dnet_settings: Dict, nnet_settings: Dict,
                 drift_net_lr: float = 2e-5, noise_net_lr: float = 2e-5,
                 weight_decay_drift: float = 1e-4, beta1: float = 0.9, beta2: float = 0.99,
                 nepoch: int = 500, eta_min: float = 1e-6, drift_loss: str = "l2",
                 noise_loss: str = "none",
                 optimize_type: str = "inputRes", optimize_target: str = "std",
                 if_MultiScoreMap: bool = True, score_map_ch_mult=(1, 1, 2, 4),
                 score_map_ngf: int = 64, use_image_context: bool = True,
                 use_degra_context: bool = False, CLIP_Type: str = "CLIP",
                 artifact_prompts: Sequence[str] = ARTIFACT_PROMPTS,
                 type_map_ind: Optional[Dict[str, int]] = None,
                 sde: Optional[DriftSDE] = None, dtype: torch.dtype = torch.float32,
                 tokenizer_vocab_path: Optional[str] = None,
                 tiny_text_encoder: bool = False, engine_opts: Optional[Dict] = None,
                 text_encoder_pretrain_path: Optional[str] = None, device="cuda",
                 if_train: bool = False, image_size: int = 224, remat="auto",
                 degrade_on_device: bool = False, seed: int = 0):
        super().__init__(dict(dnet_settings).get("context_dim", 512), CLIP_Type,
                         artifact_prompts, type_map_ind, engine_opts, dtype,
                         tokenizer_vocab_path, tiny_text_encoder, device,
                         text_encoder_pretrain_path, if_train)
        if optimize_type not in OPTIMIZE_TYPES:
            raise ValueError(f"unknown optimize_type {optimize_type!r}; "
                             f"choose from {OPTIMIZE_TYPES}")
        if optimize_target != "std":
            raise ValueError(f"optimize_target {optimize_target!r} is not supported "
                             "(only 'std')")
        self.optimize_type = optimize_type
        self.drift_loss, self.noise_loss = drift_loss, noise_loss
        self.use_dsm = dict(dnet_settings).get("use_dsm", True)
        self.use_nsm = dict(nnet_settings).get("use_nsm", True)
        self.degrade_on_device = bool(degrade_on_device)
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
        self._init_training({"drift": drift_net_lr, "noise": noise_net_lr}, beta1, beta2,
                            weight_decay_drift, nepoch, eta_min, image_size, remat, seed)

    def _load_nets(self, models_dir: str, iteration, load_ema: bool) -> None:
        """The JAX engine's ``load``: the iteration's nets; an absent prompt
        file keeps the net's current prompts; the EMA shadows, or copies of
        the online nets when an EMA file is absent."""
        def fill(key, net_tree, prompts):
            if prompts is None:
                prompts = ckpt.split_smm(flax_params(self.nets[key]))[1]
            load_flax_params(self.nets[key], ckpt.merge_smm(net_tree, prompts))

        dn, dp, nn_, np_ = ckpt.load_bundle(models_dir, iteration)
        fill("drift", dn, dp)
        fill("noise", nn_, np_)
        if not load_ema:
            return
        try:
            edn, edp, enn, enp = ckpt.load_bundle(models_dir, iteration, use_ema=True)
        except FileNotFoundError:
            self.nets["d_ema"].load_state_dict(self.nets["drift"].state_dict())
            self.nets["n_ema"].load_state_dict(self.nets["noise"].state_dict())
            return
        fill("d_ema", edn, edp)
        fill("n_ema", enn, enp)

    def _save_nets(self, models_dir: str, iteration) -> int:
        return ckpt.save_bundle(models_dir, iteration,
                                *(flax_params(self.nets[k]) for k in NET_KEYS))

    # ------------------------------------------------------------ training

    def _loss_keys(self) -> tuple:
        if self.optimize_type == "predict_x0":
            return ("l", "dl", "x0l", "dsml", "x0sml")
        return ("l", "dl", "nl", "dsml", "nsml")

    def _net_io(self, x_t, mu, x0, drift, t):
        """(drift net input, noise net input, drift target, noise target or
        None for the standard noise), each input an (x_a, x_b) pair, per
        ``optimize_type``: inputRes / predict_noise / "": drift(x_t - mu,
        mu) -> mu - x0, noise(x_t - mu, x_t) -> eps;
        predict_std_noise_acc_drift: drift(x_t, x0 + drift) -> mu - x0,
        noise(x_t, mu) -> eps (it cannot be sampled: x0 + drift is unknown
        there); predict_std_noise_scale_drift: drift(x_t, mu) -> s_d[t]
        (mu - x0), noise(x_t, mu) -> eps; predict_x0: drift(x_t, mu) ->
        mu - x0, noise(x_t, mu) -> x0. ``t`` is [B,1,1,1]."""
        d_in, n_in = self._net_inputs(x_t, mu)
        ot = self.optimize_type
        if ot == "predict_std_noise_acc_drift":
            d_in = (x_t, x0 + drift)
        if ot == "predict_std_noise_scale_drift":
            sd = self.sde.drift_schedule.to(x_t.device)[t].reshape(t.shape).to(x_t.dtype)
            return d_in, n_in, sd * (mu - x0), None
        return d_in, n_in, mu - x0, (x0 if ot == "predict_x0" else None)

    def _train_loss(self, batch, generator, t, std_noise, deg_noise):
        """The JAX engine's ``_loss_terms`` after its forward diffusion: the
        drift loss (l2 or l1), the noise loss (or with ``noise_loss`` "uni"
        the loss of the summed predictions), and the score-map pyramid losses
        of the nets whose ``use_dsm``/``use_nsm`` is on."""
        mu, x0, type_idx, img_ctx = self._train_batch(batch, generator, deg_noise)
        t, x_t, drift, std_noise, _ = self.sde.forward_diffusion(x0, mu, generator, t, std_noise)
        d_in, n_in, d_target, n_target = self._net_io(x_t, mu, x0, drift, t)
        if n_target is None:
            n_target = std_noise
        degra_ctx = None
        if self.use_degra_context:
            degra_ctx = self._encode_text(None)[type_idx][:, None, :]
        pred_drift, pred_noise, d_sms, n_sms = self._dual_forward(
            self.nets["drift"], self.nets["noise"], d_in, n_in, t.reshape(-1), type_idx,
            img_ctx, degra_ctx, plain=True)
        if self.drift_loss == "l1":
            dloss = torch.mean(torch.abs(pred_drift - d_target))
        else:
            dloss = torch.mean((pred_drift - d_target) ** 2)
        if self.noise_loss == "uni":
            nloss = torch.mean((pred_noise + pred_drift - (n_target + d_target)) ** 2)
        else:
            nloss = torch.mean((pred_noise - n_target) ** 2)
        zero = torch.zeros((), device=self.device)
        dsml = score_map_loss(d_sms, d_target) if d_sms and self.use_dsm else zero
        nsml = score_map_loss(n_sms, n_target) if n_sms and self.use_nsm else zero
        loss = dloss + nloss + dsml + nsml
        return loss, dict(zip(self._loss_keys(), (loss, dloss, nloss, dsml, nsml)))

    def _dual_forward(self, drift_net, noise_net, d_in, n_in, t, ty, img_ctx, degra_ctx,
                      plain: bool, texts=None):
        """Both UNets for one training-style step (JAX's ``_dual_forward``,
        shared by the train step and the distillation step): the drift net
        on ``d_in``, then the noise net on ``n_in`` (each an (x_a, x_b)
        pair) at the timesteps ``t`` [B]. ``plain`` runs the differentiable
        plain path (a train step, a student), else the sampling path (on
        CUDA the kernels; a teacher, under no_grad). ``texts``: the two
        nets' per-SMM text encodings, else encoded here (inside the autograd
        graph when gradients are on). JAX vmaps the two nets over stacked
        parameters when their settings match, which computes the same
        values. Returns (pred_drift, pred_noise, drift score maps, noise
        score maps)."""
        if texts is None:
            texts = (self._encode_prompts(drift_net), self._encode_prompts(noise_net))
        pred_drift, d_sms = drift_net(d_in[0], d_in[1], t, ty, texts[0], img_ctx, degra_ctx,
                                      plain=plain)
        pred_noise, n_sms = noise_net(n_in[0], n_in[1], t, ty, texts[1], img_ctx, degra_ctx,
                                      plain=plain)
        return pred_drift, pred_noise, d_sms, n_sms

    # ------------------------------------------------------------ sampling

    def _net_inputs(self, x, mu):
        """(x_a, x_b) of the drift net and of the noise net, in sampling and
        (but for ``predict_std_noise_acc_drift``'s drift net) in training."""
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

    def test(self, batch, *args, **kwargs):
        """``SamplingEngine.test``; an engine trained with
        ``predict_std_noise_acc_drift`` cannot sample and raises, as JAX's
        ``build_sample_fn`` does."""
        if self.optimize_type == "predict_std_noise_acc_drift":
            raise ValueError(
                "optimize_type 'predict_std_noise_acc_drift' conditions the drift net on "
                "x0+drift, which is unavailable at sampling time (training-only ablation; "
                "reference drift_noise_model.py:314)")
        return super().test(batch, *args, **kwargs)

    def attach_image_tower(self, tower) -> None:
        """Embed each sampler call's input on the device: with
        ``use_image_context`` the image context becomes ``tower``'s
        L2-normalised float32 embedding of ``mu`` (``clip_vit.
        image_context``), computed once per call before the step loop, as
        the JAX sampler hoists it before its scan; ``batch["A_emb"]`` is
        then not read. The tower is moved to the engine's device, frozen
        and kept in float32 whatever the engine's dtype. A captured graph
        reads the image context from its static buffer, refilled each call,
        so no graph is captured anew. Training keeps the batch's
        ``A_emb``, as in JAX."""
        self.image_tower = cast_compute_(tower.to(self.device), torch.float32).eval() \
            .requires_grad_(False)

    def _inputs(self, batch, use_ema: bool):
        """The call's tensors: mu, type ids, the image context and (with
        ``use_degra_context``) the prompt's encoding without learnable
        context as one token, and each net's per-SMM text encodings."""
        mu = self._tensor(batch["input"], torch.float32)
        type_idx = self._tensor(batch["type_idx"], torch.int64)
        degra_ctx = None
        if self.use_degra_context:
            degra_ctx = self._encode_text(None)[type_idx][:, None, :]
        dnet, nnet = self._step_nets(use_ema)
        return {"mu": mu, "type_idx": type_idx,
                "img_ctx": self._image_context(batch, mu.shape[0], mu),
                "degra_ctx": degra_ctx, "d_text": self._encode_prompts(dnet),
                "n_text": self._encode_prompts(nnet)}

    def _predictor(self, inputs, use_ema: bool, sp=None):
        """``predict(x, row)``: the drift net, then the noise net, at the
        row's timestep, reading the call's tensors from ``inputs``; with
        ``sp`` on this rank's rows."""
        dnet, nnet = self._step_nets(use_ema)
        mu, type_idx = inputs["mu"], inputs["type_idx"]
        img_ctx, degra_ctx = inputs["img_ctx"], inputs["degra_ctx"]
        B = mu.shape[0]

        def predict(x, row):
            t_b = row[0].to(torch.int32).expand(B)
            d_in, n_in = self._net_inputs(x, mu)
            pd, _ = dnet(d_in[0], d_in[1], t_b, type_idx, inputs["d_text"], img_ctx, degra_ctx,
                         sp=sp)
            pn, _ = nnet(n_in[0], n_in[1], t_b, type_idx, inputs["n_text"], img_ctx, degra_ctx,
                         sp=sp)
            return self._to_drift_eps(x, row, pd, pn)

        return predict


def create_CLIPDriftModel(train_opt, model_opt, phase="train", **kwargs) -> CLIPDriftEngine:
    """The engine of a ``models.DriftNoise`` option block, read with the JAX
    factory's defaults (``create_CLIPDriftModel`` in
    ``instancediff_tpu/models/drift_model.py``); ``kwargs`` (``device``,
    ``sde``, ``type_map_ind``, ...) go to the engine, see
    ``engine.factory_kwargs``. ``phase == "train"`` builds an engine that
    trains, with ``train_opt``'s ``nepoch``."""
    kwargs.setdefault("type_map_ind", model_opt.get("type_map_ind"))
    return CLIPDriftEngine(
        dnet_settings=dict(model_opt["dnet_settings"]),
        nnet_settings=dict(model_opt["nnet_settings"]),
        drift_net_lr=model_opt.get("drift_net_lr", 2e-5),
        noise_net_lr=model_opt.get("noise_net_lr", 2e-5),
        weight_decay_drift=model_opt.get("weight_decay_drift", 1e-4),
        nepoch=(train_opt or {}).get("nepoch", 500),
        drift_loss=model_opt.get("drift_loss", "l2"),
        noise_loss=model_opt.get("noise_loss", "none"),
        optimize_type=model_opt.get("optimize_type", "inputRes"),
        optimize_target=model_opt.get("optimize_target", "std"),
        if_MultiScoreMap=model_opt.get("if_MultiScoreMap", True),
        score_map_ch_mult=tuple(model_opt.get("score_map_ch_mult", (1, 1, 2, 4))),
        score_map_ngf=model_opt.get("score_map_ngf", 64),
        **factory_kwargs(model_opt, kwargs, phase))
