"""What the engines share (``drift_model.CLIPDriftEngine`` and
``ddpm_model.CLIPDDPMEngine``): the device, the engine knobs, the
artifact-type map, the frozen text tower (CLIP, or BiomedCLIP's PubMedBERT
with ``CLIP_Type: BiomedCLIP``) with the prompts' token ids (and mask) and
its weights, the image context (``batch["A_emb"]``, or an attached image
tower's embedding of the input), the sampler call ``test`` with its compiled form, and the
training state around an engine's train step (optimizers, EMA, learning
rate, loss messages, ``{iter}.state`` files).

A weight bundle (``utils/checkpoint.py``) holds the nets but not the frozen
text tower: the JAX engines draw it from their seed, or read a torch CLIP
or BiomedCLIP checkpoint (``text_encoder_pretrain_path``). The port reads the same
checkpoint, or the tower's weights from a sidecar ``text_params.ckpt`` beside
the bundle, which ``tools/export_text_params.py`` writes with JAX; it refuses
to load a bundle with neither, since its own random tower is not the one the
nets were trained with.

The compiled sampler is the port's ``jax.jit`` of the JAX engines' ``lax.scan``
(``instancediff_tpu/models/drift_model.py:794-804``): on CUDA, ``test``
captures ONE sampler step in a ``torch.cuda.CUDAGraph`` per cache key (batch
shape, steps, eta, EMA, contexts) and replays it once per step. What a call
brings (the degraded input, type ids, image context, text encodings) is
copied into the graph's static buffers; the initial noise and each step's
noise are drawn from the caller's generator outside the graph, in the eager
loop's order, so the graph and the eager loop consume the same numbers. The
nets' weights are read by address too, so a graph is captured anew when
they have been updated in place since its capture.

An engine built to train (``if_train``) keeps its nets' parameters in
float32 and casts them where they are used (``layers.cast_compute_`` with
``master``), as flax's ``dtype=bf16`` modules do with float32 parameters:
Adam and the EMA update float32 values. Its train step runs the nets'
differentiable plain path (``unet.py``), where no CUDA kernel runs, as the
JAX package trains through its reference versions."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .. import parallel
from ..device import resolve_device
from ..ops.degradations import apply_degradation
from ..ops.flash_attention import flash_attention
from ..ops.fused_gn_conv import fused_gn_silu_conv3x3, gn_channel_affine, packed_copies
from ..ops.group_norm_silu import group_norm_silu
from ..ops.resize import downsample_label
from ..sde.schedules import strided_sampling_grid
from ..parallel.spatial import shard_spatial
from ..sde.stepping import SamplerState, run_steps
from ..utils.checkpoint import (load_pytree, load_training_state, save_pytree,
                                save_training_state)
from ..utils.convert import adam_state, flax_params, load_adam_state, load_flax_params
from .layers import cast_compute_, flax_init_
from .optim import cosine_annealing_lr, ema_update, make_adam, set_lr
from .clip_vit import image_context
from .text_encoder import (HFContextTextEncoder, build_text_encoder, load_torch_bert_weights,
                           load_torch_clip_text_weights)
from .tokenizer import BertWordPieceTokenizer, ClipBPETokenizer, default_vocab_path
from .unet import LearnableForwardUNetMultiScoreMap

ARTIFACT_PROMPTS = (
    "speckle in OCT",
    "speckle in ultra sound",
    "noise in cryo-EM image",
    "noise in low dose CT",
    "Gaussian noise in MRI",
)
# the JAX engines' ``engine:`` knobs (instancediff_tpu/models/drift_model.py
# ENGINE_KNOBS); an unknown key raises, as there
ENGINE_KNOBS = frozenset(
    {"pallas_gn", "fused_gnconv", "scan_unroll", "fuse_dual_train",
     "packed_l0", "ksplit_dec", "int8_conv", "decomp_l0", "tapsum_out",
     "shift_l0", "flash_mid", "gnfold_l0", "hoist_noise", "subpix_up",
     "presum_dec"}
)
# the kernel wrappers a sampler step launches: ``launches`` counts the
# kernels each launched, ``captured`` those it recorded into a graph
# (``ops/_build.py:count_launch``)
KERNELS = {"fused_gn_silu_conv3x3": fused_gn_silu_conv3x3,
           "gn_channel_affine": gn_channel_affine, "group_norm_silu": group_norm_silu,
           "flash_attention": flash_attention}


# the frozen text tower's weights beside a bundle, and the script that
# writes them from a JAX engine
TEXT_SIDECAR = "text_params.ckpt"
EXPORT_TOOL = "tools/export_text_params.py"


def resolve_dtype(name) -> torch.dtype:
    """A ``models.<name>.dtype`` option as the compute dtype."""
    if name is None or name in ("float32", "fp32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unsupported models.<name>.dtype {name!r}")


def factory_kwargs(model_opt: Dict, kwargs: Dict, phase: str = "train") -> Dict:
    """The engine arguments a ``create_*`` factory takes from its option block
    and keyword arguments, shared by both engines (each factory adds its
    own learning rates and losses). ``phase == "train"`` builds an engine
    that trains (``if_train``), as the JAX factories do. The block's
    ``packed_train`` is a TPU layout knob and is not read."""
    kw = dict(kwargs)
    return dict(
        use_image_context=model_opt.get("use_image_context", True),
        use_degra_context=model_opt.get("use_degra_context", False),
        degrade_on_device=bool(model_opt.get("degrade_on_device")),
        CLIP_Type=model_opt.get("CLIP_Type", "CLIP"),
        text_encoder_pretrain_path=model_opt.get("text_encoder_pretrain_path"),
        tiny_text_encoder=bool(model_opt.get("tiny_text_encoder")),
        tokenizer_vocab_path=model_opt.get("tokenizer_vocab_path"),
        beta1=model_opt.get("beta1", 0.9), beta2=model_opt.get("beta2", 0.99),
        eta_min=model_opt.get("eta_min", 1e-6), if_train=phase == "train",
        engine_opts=model_opt.get("engine"), dtype=resolve_dtype(model_opt.get("dtype")), **kw)


def kernel_launches(counter: str = "launches") -> Dict[str, int]:
    return {name: getattr(fn, counter) for name, fn in KERNELS.items()}


def graph_key(shape, n_steps: int, eta: float, use_ema: bool, image_context: bool,
              degra_context: bool) -> tuple:
    """The compiled sampler's cache key: JAX's jit cache key ``(sample_steps,
    eta)`` (here the grid's step count and the resolved eta), plus what jit
    keys on implicitly (the batch shape; the compute dtype is the engine's,
    fixed at construction), the nets (``use_ema``) and which context tokens
    the step reads."""
    return (tuple(int(s) for s in shape), int(n_steps), float(eta), bool(use_ema),
            bool(image_context), bool(degra_context))


def weights_version(nets) -> tuple:
    """(address, version) of every parameter and buffer of ``nets``: any
    in-place update (``copy_``, an optimizer or EMA step) or reassignment
    changes it."""
    return tuple((t.data_ptr(), t._version) for net in nets
                 for t in (*net.parameters(), *net.buffers()))


class CompiledStep:
    """One sampler step captured in a CUDA graph, with the static buffers it
    reads: ``inputs`` (the call's tensors, by the engine's names) and
    ``state`` (``x``, ``z``, the step index and the coefficient table).
    ``launches``: kernel launches per step by wrapper name, recorded while
    the step was captured; each replay adds them to the wrappers'
    ``launches``. ``weights``: the nets' ``weights_version`` at capture;
    ``keep``: the packed conv weights the graph reads, held here so that a
    repack cannot free them under it. ``calls``: sampler calls served;
    ``replays``: steps replayed."""

    def __init__(self, graph, inputs: Dict, state: SamplerState, launches: Dict[str, int],
                 weights: tuple, keep: list):
        self.graph = graph
        self.inputs = inputs
        self.state = state
        self.launches = launches
        self.weights = weights
        self.keep = keep
        self.calls = 0
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            KERNELS[name].launches += n


def _clone_inputs(inputs: Dict) -> Dict:
    """Static copies of a call's tensors (tensors, lists of tensors or None)."""
    return {k: [t.clone() for t in v] if isinstance(v, list) else None if v is None
            else v.clone() for k, v in inputs.items()}


def _copy_into(dst: Dict, src: Dict) -> None:
    """Copy a call's tensors into the static buffers of the same names."""
    for k, v in src.items():
        if v is None:
            continue
        for d, s in zip(dst[k], v) if isinstance(v, list) else [(dst[k], v)]:
            d.copy_(s)


def score_map_loss(score_maps, label: torch.Tensor) -> torch.Tensor:
    """The score-map pyramid loss (``optimize_score_map``): each level's map
    against the label downsampled by 2^level, mean squared error, summed
    and halved."""
    return sum(torch.mean((sm - downsample_label(label, 2**i)) ** 2)
               for i, sm in enumerate(score_maps)) / 2.0


class SamplingEngine:
    """Base of the engines.

    ``engine_opts`` takes the JAX engines' knobs. ``fused_gnconv`` is read by
    the drift engine; every other knob is accepted and changes nothing here:
    on CUDA the port always runs its GroupNorm and flash-attention kernels
    (``pallas_gn``, ``flash_mid``), and the TPU layout rewrites (``packed_l0``
    and the rest) are not ported. In JAX each of these knobs picks between
    value-identical graphs, so ignoring one changes no output."""

    def __init__(self, context_dim: int, CLIP_Type: str, artifact_prompts: Sequence[str],
                 type_map_ind: Optional[Dict[str, int]], engine_opts: Optional[Dict],
                 dtype: torch.dtype, tokenizer_vocab_path: Optional[str],
                 tiny_text_encoder: bool, device, text_encoder_pretrain_path=None,
                 if_train: bool = False):
        self.device = resolve_device(device)
        self.if_train = bool(if_train)
        self.optimizers: Dict[str, torch.optim.Adam] = {}
        # the train state sharded over a dp x fsdp grid (``shard_fsdp``)
        self.fsdp = None
        self.engine_opts = dict(engine_opts or {})
        unknown = sorted(set(self.engine_opts) - ENGINE_KNOBS)
        if unknown:
            raise KeyError(f"unknown engine knob {unknown[0]!r}; valid: {sorted(ENGINE_KNOBS)}")
        self.dtype = dtype
        self.context_dim = context_dim
        self.num_prompts = len(artifact_prompts)
        self.type_map = dict(type_map_ind) if type_map_ind else {
            name: i for i, name in enumerate(artifact_prompts)}
        text, self.token_embed_dim = build_text_encoder(context_dim, tiny=tiny_text_encoder,
                                                        clip_type=CLIP_Type)
        # the prompts' ids, and for the BERT tower their mask ([CLS] text
        # [SEP] padded to the context length); None for CLIP's BPE ids
        self.prompt_mask = None
        bert = isinstance(text, HFContextTextEncoder)
        if tokenizer_vocab_path is None and not tiny_text_encoder:
            # the reference's vocab when present, as the JAX engines find it;
            # a tiny tower (vocab 512) keeps the hashed ids
            tokenizer_vocab_path = default_vocab_path("bert" if bert else "bpe")
        if bert:
            tok = BertWordPieceTokenizer(tokenizer_vocab_path,
                                         context_length=text.context_length,
                                         vocab_size=text.vocab_size)
            ids, mask = tok(list(artifact_prompts))
            self.prompt_mask = torch.from_numpy(mask).to(self.device)
            load_pretrained = load_torch_bert_weights
        else:
            tok = ClipBPETokenizer(tokenizer_vocab_path, context_length=text.context_length,
                                   vocab_size=text.vocab_size)
            ids = tok(list(artifact_prompts))
            load_pretrained = load_torch_clip_text_weights
        self.prompt_ids = torch.from_numpy(ids).to(self.device)
        self.text_encoder = cast_compute_(text.to(self.device), dtype).eval().requires_grad_(False)
        # where the tower's weights come from: "pretrained" (a torch CLIP or
        # BiomedCLIP checkpoint, as the JAX engines read it when the file
        # exists), "sidecar" (a bundle's text_params.ckpt) or None (the
        # random init)
        self.text_weights = None
        if text_encoder_pretrain_path and os.path.isfile(str(text_encoder_pretrain_path)):
            load_pretrained(self.text_encoder, str(text_encoder_pretrain_path))
            self.text_weights = "pretrained"
        # an image tower that embeds the sampler's input as the image context
        # (``drift_model.CLIPDriftEngine.attach_image_tower``); None: the
        # batch's ``A_emb``
        self.image_tower = None
        # the compiled sampler: graphs by ``graph_key``, captures so far, the
        # graph the last compiled call replayed, and (made at the first
        # capture) the one memory pool all of the engine's graphs share and
        # the stream they are captured on
        self.graphs: Dict[tuple, CompiledStep] = {}
        self.captures = 0
        self.last_graph: Optional[CompiledStep] = None
        self._pool = None
        self._stream = None
        # the last sampler call's result (``get_visuals``)
        self.output: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ bundles
    # An engine provides ``_load_nets(models_dir, iteration, load_ema)`` and
    # ``_save_nets(models_dir, iteration)`` for its nets' files.

    def load(self, models_dir: str, iteration, use_ema: bool = False,
             load_ema: bool = True) -> None:
        """Fill the nets from the bundle ``iteration`` in ``models_dir`` (the
        JAX engines' ``load``: ``use_ema`` is accepted and, as there, unused;
        ``load_ema`` reads the EMA shadows too, or copies the online weights
        where they are absent) and the text tower from the sidecar, when the
        tower was not loaded from a checkpoint. Parameters are updated in
        place, so a captured sampler graph is captured anew at its next call."""
        sidecar = os.path.join(models_dir, TEXT_SIDECAR)
        if not os.path.isfile(sidecar) and self.text_weights != "pretrained":
            raise FileNotFoundError(
                f"{sidecar} is missing and the frozen text tower was not loaded from "
                "text_encoder_pretrain_path: the bundle holds no text tower, and this "
                "engine's random one is not the tower its nets were trained with. Write "
                f"the sidecar with JAX: python {EXPORT_TOOL} -opt <config> --models-dir "
                f"{models_dir} (with the training seed)")
        self._load_nets(models_dir, iteration, load_ema)
        if os.path.isfile(sidecar):
            load_flax_params(self.text_encoder, load_pytree(sidecar))
            self.text_weights = "sidecar"

    def save(self, models_dir: str, iteration) -> int:
        """Write the nets as the JAX engines' ``save`` does (flax layout, the
        same file names) and the text tower's sidecar; returns the bytes
        written."""
        return (self._save_nets(models_dir, iteration)
                + save_pytree(flax_params(self.text_encoder),
                              os.path.join(models_dir, TEXT_SIDECAR)))

    def _build_unet(self, settings: Dict, **kw) -> LearnableForwardUNetMultiScoreMap:
        """One UNet from a ``net_settings`` block, computing in the compute
        dtype on the engine's device (float32 master weights when the engine
        trains), its parameters frozen until ``_init_training`` trains it;
        ``kw`` gives the engine-level fields. A net without SMM text
        conditioning (``text_module`` other than ``"scoremap"``) is refused:
        the JAX engines unpack ``(pred, score maps)`` from every forward, so
        no JAX engine serves or trains one."""
        s = dict(settings)
        if s.get("text_module", "scoremap") != "scoremap":
            raise ValueError(f"net_settings text_module {s['text_module']!r}: the engines "
                             "take only text_module 'scoremap' (build the net alone with "
                             "models.modules.create_net)")
        net = LearnableForwardUNetMultiScoreMap(
            in_nc=s.get("in_nc", 2), out_nc=s.get("out_nc", 5), nf=s.get("nf", 64),
            ch_mult=tuple(s.get("ch_mult", (1, 2, 4, 4))),
            context_dim=s.get("context_dim", 512),
            text_module=s.get("text_module", "scoremap"),
            score_map_chan=s.get("score_map_chan", 16),
            token_embed_dim=self.token_embed_dim,
            num_res_blocks=s.get("num_res_blocks", 2), num_prompts=self.num_prompts, **kw)
        return cast_compute_(net.to(self.device), self.dtype, master=self.if_train).eval() \
            .requires_grad_(False)

    def _encode_text(self, context) -> torch.Tensor:
        """[K, context_dim] encodings of the prompts with the learnable
        ``context`` tokens spliced in (None: without context)."""
        if self.prompt_mask is not None:
            return self.text_encoder(self.prompt_ids, self.prompt_mask, context)
        return self.text_encoder(self.prompt_ids, context)

    def _encode_prompts(self, net) -> list:
        """Per-SMM [K, context_dim] text encodings for one net's contexts."""
        return [self._encode_text(ctx) for ctx in net.smm_contexts()]

    def _tensor(self, value, dtype):
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def _image_context(self, batch, B: int, mu: Optional[torch.Tensor] = None):
        """None without image context; else, for a sampler call (``mu``
        given) on an engine with an image tower, the tower's normalised
        embedding of ``mu`` [B,1,context_dim] in float32; else
        ``batch["A_emb"]`` (zeros when absent). Training reads the batch's,
        as the JAX train step does."""
        if not self.use_image_context:
            return None
        if mu is not None and self.image_tower is not None:
            with record_function("image_tower"):
                return image_context(self.image_tower, mu)
        a_emb = batch.get("A_emb")
        return (torch.zeros(B, 1, self.context_dim, device=self.device)
                if a_emb is None else self._tensor(a_emb, torch.float32))

    # ------------------------------------------------------------ training
    # An engine that trains names its trained nets in ``TRAINED``: {net key:
    # (optimizer state key, EMA net key)}, the JAX engine's ``state`` keys,
    # and provides ``_train_loss(batch, generator, t, std_noise, deg_noise)
    # -> (loss, {name: term})``, "l" (the loss) first, on the nets' plain
    # path, and ``_loss_keys()``: the names of the terms.

    def _init_training(self, lrs: Dict[str, float], beta1: float, beta2: float,
                       weight_decay: float, nepoch: int, eta_min: float, image_size: int,
                       remat, seed: int) -> None:
        """Optimizers and EMA shadows for the nets in ``TRAINED`` (none
        unless ``if_train``). The trained nets are drawn from the JAX
        modules' initialisers (``layers.flax_init_``, from ``seed``; torch
        cannot draw JAX's values) and their EMA shadows copied from them, as
        the JAX engines start. ``remat`` (True/False/"auto": on at
        ``image_size >= 128``, JAX's rule) rematerialises the ResBlocks in
        the backward."""
        self.lr0 = dict(lrs)
        self.nepoch, self.eta_min = int(nepoch), float(eta_min)
        self.step = 0
        self.ema_restored = False
        self.reinit_loss_message()
        if not self.if_train:
            return
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for key, (_, ema_key) in self.TRAINED.items():
            net = flax_init_(self.nets[key], gen).requires_grad_(True)
            net.remat = image_size >= 128 if remat == "auto" else bool(remat)
            self.nets[ema_key].load_state_dict(net.state_dict())
            self.optimizers[key] = make_adam(net.parameters(), lrs[key], beta1, beta2,
                                             weight_decay)

    def _train_batch(self, batch, generator, deg_noise):
        """(mu, x0, type ids, image context) of a train batch; with
        ``degrade_on_device`` mu is synthesised from the target
        (``ops/degradations.apply_degradation``, its five noises from
        ``deg_noise`` or the generator), as the JAX train step does."""
        x0 = self._tensor(batch["target"], torch.float32)
        type_idx = self._tensor(batch["type_idx"], torch.int64)
        if self.degrade_on_device:
            mu = apply_degradation(x0, type_idx, generator=generator, noise=deg_noise)
        else:
            mu = self._tensor(batch["input"], torch.float32)
        return mu, x0, type_idx, self._image_context(batch, x0.shape[0])

    def optimize_parameters(self, batch, generator: Optional[torch.Generator] = None,
                            epoch: int = 0, t: Optional[torch.Tensor] = None,
                            std_noise: Optional[torch.Tensor] = None,
                            deg_noise: Optional[Sequence[torch.Tensor]] = None) -> float:
        """One train step, the JAX engines' jitted one: forward diffusion,
        the nets on their plain path with the text encodings computed inside
        the autograd graph (gradients reach the SMM contexts through the
        frozen tower), the losses, backward, one Adam step per trained net at
        the epoch's cosine learning rate, the step counter, then the EMA.
        ``batch``: ``input``/``target`` [B,H,W,1] in [-1,1], ``type_idx``
        [B], optional ``A_emb`` [B,1,context_dim]. The timesteps ``t`` [B],
        the standard noise ``std_noise`` and the degradation's five noises
        ``deg_noise`` replace draws from ``generator`` (degradation first,
        then t, then the noise). A parameter the loss does not reach gets a
        zero gradient, so weight decay still moves it, as optax's update of
        the whole tree does. In a process group the gradients and the
        recorded loss terms are the ranks' means (``_apply_gradients``).
        Returns the loss."""
        if not self.optimizers:
            raise RuntimeError("this engine samples only: build it with if_train=True "
                               "(create_model(..., phase='train'))")
        if self.sde is None:
            raise ValueError("engine has no SDE; pass sde= to the constructor")
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)
        if self.fsdp is not None:
            self.fsdp.gather_()
        with torch.enable_grad():
            loss, terms = self._train_loss(batch, generator, t, std_noise, deg_noise)
            loss.backward()
        self._apply_gradients({key: cosine_annealing_lr(epoch, self.nepoch, self.lr0[key],
                                                        self.eta_min)
                               for key in self.optimizers})
        values = torch.stack([v.detach().float().reshape(()) for v in terms.values()])
        # the global batch's loss terms (its dp slices' under FSDP)
        parallel.all_reduce_mean_([values], self.fsdp.grid.dp_group if self.fsdp else None)
        values = values.tolist()
        self._record_losses(dict(zip(terms, values)))
        return values[0]

    def _apply_gradients(self, lrs: Dict[str, float]) -> None:
        """After a backward: one Adam step per trained net at its learning
        rate in ``lrs`` (a parameter the loss did not reach gets a zero
        gradient), the step counter, then the EMA shadows. In a process
        group the gradients are first averaged over the ranks (every rank
        reduces every trained net's every gradient, in one order), so each
        rank steps on the global batch's mean loss. Under FSDP each rank
        steps its shards (``parallel/mesh.py``) and releases the whole
        parameters."""
        if self.fsdp is not None:
            self.fsdp.reduce_gradients_()
            for key, opt in self.optimizers.items():
                set_lr(opt, lrs[key])
                opt.step()
            self.step += 1
            self.fsdp.ema_step_(self.step)
            self.fsdp.release_()
            return
        grads = []
        for key in self.optimizers:
            for p in self.nets[key].parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        parallel.all_reduce_mean_(grads)
        for key, opt in self.optimizers.items():
            set_lr(opt, lrs[key])
            opt.step()
        self.step += 1
        for key, (_, ema_key) in self.TRAINED.items():
            ema_update(self.nets[ema_key], self.nets[key], self.step)

    def reinit_loss_message(self) -> None:
        keys = self._loss_keys()
        self.loss_info = {"latest": {k: 0.0 for k in keys}, "avg": {k: 0.0 for k in keys},
                          "num": 0}

    def _record_losses(self, terms: Dict[str, float]) -> None:
        for k, v in terms.items():
            self.loss_info["latest"][k] = v
            self.loss_info["avg"][k] = self.loss_info["avg"].get(k, 0.0) + v
        self.loss_info["num"] += 1

    def get_loss_message(self) -> str:
        num = max(self.loss_info["num"], 1)
        return "".join("({}={:4f}/{:4f})".format(k, self.loss_info["latest"][k],
                                                   self.loss_info["avg"][k] / num)
                       for k in self.loss_info["latest"])

    def get_current_learning_rate(self, epoch: int = 0) -> float:
        return cosine_annealing_lr(epoch, self.nepoch, self.lr0["noise"], self.eta_min)

    def save_training_state(self, state_dir: str, epoch: int, iteration) -> int:
        """``{iter}.state`` as the JAX engines write it: each trained net's
        optimizer state (optax's layout), the step and the EMA shadows;
        returns the bytes written. Under FSDP every rank must call it: the
        shards are gathered and rank 0 writes the file an unsharded run
        writes (0 bytes elsewhere)."""
        opt = {"step": np.asarray(self.step, np.int32)}
        if self.fsdp is not None:
            self.fsdp.gather_()
            self.fsdp.gather_(ema=True)
        try:
            for key, (opt_key, ema_key) in self.TRAINED.items():
                adam = self.fsdp.adam_view(key) if self.fsdp else self.optimizers[key]
                opt[opt_key] = adam_state(adam, self.nets[key])
                opt[ema_key] = flax_params(self.nets[ema_key])
        finally:
            if self.fsdp is not None:
                self.fsdp.release_()
        if self.fsdp is not None and parallel.rank() != 0:
            return 0
        return save_training_state(state_dir, iteration, epoch, opt)

    def shard_fsdp(self, grid) -> None:
        """Shard the trained nets' parameters, Adam's moments and the EMA
        shadows over ``grid`` (a ``parallel.mesh.Grid``, dp x fsdp), ZeRO
        style (``parallel.mesh.FSDPState``): each train step gathers the
        parameters whole, averages the gradients over dp, steps this rank's
        shards and releases the whole parameters again. Feed each rank its
        dp slice of the batch (``parallel.shard_batch(batch, grid.dp_rank,
        grid.dp)``). ``fsdp.gather_()`` / ``gather_(ema=True)`` make the nets
        whole between steps (to sample or save them)."""
        from ..parallel.mesh import FSDPState

        if not self.optimizers:
            raise RuntimeError("shard_fsdp shards a train state: build the engine to train")
        self.fsdp = FSDPState(self, grid)

    def resume_training(self, state_path: str) -> tuple:
        """Restore the optimizers and the step, and the EMA shadows when the
        state carries them (``ema_restored``: the caller then skips the
        rolling EMA files in ``load``); returns (epoch, iter)."""
        tree = load_training_state(state_path)
        opt = tree["opt"]
        for key, (opt_key, _) in self.TRAINED.items():
            load_adam_state(self.optimizers[key], self.nets[key], opt[opt_key])
        self.step = int(opt["step"])
        self.ema_restored = all(ema_key in opt for _, ema_key in self.TRAINED.values())
        if self.ema_restored:
            for _, ema_key in self.TRAINED.values():
                load_flax_params(self.nets[ema_key], opt[ema_key])
        return tree["epoch"], tree["iter"]

    # ------------------------------------------------------------ sampling
    # An engine provides ``_inputs(batch, use_ema)``: a dict of the call's
    # tensors (``mu``, ``type_idx``, ``img_ctx``, ``degra_ctx`` and the text
    # encodings, None where absent), ``_predictor(inputs, use_ema)``:
    # ``predict(x, row)`` for ``sde.step``, reading only those tensors (with
    # ``sp``, a ``SpatialGroup``: this rank's rows of x and mu), and
    # ``_step_nets(use_ema)``: the nets that ``predict`` runs, named in
    # ``NET_NAMES`` (the JAX engine's ``get_nets`` keys).

    def set_sde(self, sde) -> None:
        """Train and sample with ``sde`` from now on (JAX's ``set_sde``, which
        drops the jitted train step and sampler built on the old one). The
        captured sampler graphs read the old SDE's coefficient table, and
        ``graph_key`` does not name the SDE, so they are dropped: the next
        compiled call captures anew."""
        self.sde = sde
        self.graphs.clear()
        self.last_graph = None

    def get_visuals(self) -> np.ndarray:
        """The last sampler call's result as a numpy array (on CUDA that
        call's own output, not a graph buffer a later replay rewrites)."""
        if self.output is None:
            raise RuntimeError("no sampler call yet: call test first")
        return self.output.cpu().numpy()

    def get_nets(self, use_ema: bool = False) -> Dict[str, torch.nn.Module]:
        """The sampler's nets (or their EMA shadows) under the JAX engine's
        keys, ``NET_NAMES``."""
        return dict(zip(self.NET_NAMES, self._step_nets(use_ema)))

    @torch.inference_mode()
    def test(self, batch, generator: Optional[torch.Generator] = None, use_ema: bool = True,
             sample_steps: Optional[int] = None, eta: Optional[float] = None,
             init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[Sequence[torch.Tensor]] = None,
             compiled: Optional[bool] = None, spatial=None) -> torch.Tensor:
        """Restore a batch: ``batch["input"]`` [B,H,W,1] in [-1,1] (the
        degraded image mu), ``batch["type_idx"]`` [B], optional
        ``batch["A_emb"]`` [B,1,context_dim] (zeros when absent; used with
        image context unless an image tower is attached). Returns x0_hat
        [B,H,W,1] float32 on the engine's device. Noise comes from
        ``generator`` unless ``init_noise`` and ``step_noise`` are given
        (see ``stepping.run_steps``).

        ``compiled`` (default: True on CUDA, False on the CPU) replays one
        captured graph per sampler step, captured at the first call of each
        ``graph_key`` and cached on the engine (captured anew when the
        nets' weights changed since); False runs the same step eagerly, one
        launch per kernel (JAX without ``jit``). A failed capture or replay
        raises; there is no fallback to the eager loop.

        ``spatial`` (a ``parallel.spatial.SpatialGroup``; JAX's batch
        sharded with ``shard_spatial``) splits the images' height over its
        ranks: every rank passes the whole batch and the same seeded
        generator (or the same noise), the call's inputs are made whole
        (text encodings, image context), then each rank samples its own rows
        (``shard_spatial``; the nets with ``sp``, the noise drawn whole and
        sliced) and the result is gathered to the whole images on every
        rank. An image height that does not split at every level of the
        nets raises (``check_spatial``). A sharded call runs its steps
        eagerly: its collectives go through gloo or NCCL calls that a CUDA
        graph does not capture here (``compiled=True`` raises)."""
        if self.sde is None:
            raise ValueError("engine has no SDE; pass sde= to the constructor")
        sharded = spatial is not None and spatial.world > 1
        if sharded and compiled:
            raise ValueError("a spatially sharded call runs eagerly (compiled=False)")
        if compiled is None:
            compiled = self.device.type == "cuda" and not sharded
        elif compiled and self.device.type != "cuda":
            raise ValueError("compiled=True captures a CUDA graph; this engine lives on "
                             f"{self.device} (pass compiled=False)")
        if self.degrade_on_device and "target" in batch:
            # a GT-only batch: its input is synthesised on the device, as in
            # the train step (JAX's test does the same with its own key)
            batch = dict(batch, input=apply_degradation(
                self._tensor(batch["target"], torch.float32),
                self._tensor(batch["type_idx"], torch.int64), generator=generator))
        with record_function("sampler_inputs"):
            inputs = self._inputs(batch, use_ema)
        if sharded:
            _, H, W, _ = inputs["mu"].shape
            for net in self._step_nets(use_ema):
                net.check_spatial(H, W, spatial.world)
            inputs = shard_spatial(inputs, spatial)
            x = self.sde.reverse_ddpm(
                inputs["mu"], self._predictor(inputs, use_ema, spatial), eta=eta,
                sample_steps=sample_steps, generator=generator, init_noise=init_noise,
                step_noise=step_noise, sp=spatial)
            self.output = spatial.gather_h(x)
            return self.output
        if not compiled:
            self.output = self.sde.reverse_ddpm(
                inputs["mu"], self._predictor(inputs, use_ema), eta=eta,
                sample_steps=sample_steps, generator=generator, init_noise=init_noise,
                step_noise=step_noise)
            return self.output
        key = self._graph_key(inputs, use_ema, sample_steps, eta)
        entry = self.graphs.get(key)
        if entry is not None and entry.weights != weights_version(self._step_nets(use_ema)):
            del self.graphs[key]  # the weights were updated since its capture
            entry = None
        if entry is None:
            entry = self.graphs[key] = self._capture(inputs, use_ema, sample_steps, eta)
        else:
            _copy_into(entry.inputs, inputs)
        self.last_graph = entry
        entry.calls += 1
        run_steps(self.sde, entry.state, entry.inputs["mu"], entry.replay, generator,
                  init_noise, step_noise)
        self.output = entry.state.x.clone()
        return self.output

    def _graph_key(self, inputs, use_ema: bool, sample_steps: Optional[int],
                  eta: Optional[float]) -> tuple:
        """``graph_key`` of a call with ``inputs`` (only their shapes and
        which contexts are present are read)."""
        n_steps = len(strided_sampling_grid(self.sde.T, sample_steps)[0])
        return graph_key(inputs["mu"].shape, n_steps, self.sde.eta if eta is None else eta,
                         use_ema, inputs.get("img_ctx") is not None,
                         inputs.get("degra_ctx") is not None)

    def _capture(self, inputs, use_ema: bool, sample_steps: Optional[int],
                 eta: Optional[float]) -> CompiledStep:
        """Static copies of ``inputs``, a sampler state with this call's
        coefficient table, one eager warm-up step on the capture stream, then
        the step captured into the engine's memory pool.

        The warm-up does every step's first-call work outside the capture:
        it loads the kernel libraries, packs the fused conv's weights, sets
        the kernels' shared-memory limits, allocates the GroupNorm scratch of
        the capture stream (the scratch the graph then reads) and creates
        cuBLAS's workspace for that stream. Its result is discarded:
        ``run_steps`` starts every call from x_T at step 0."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static = _clone_inputs(inputs)
        state = SamplerState(static["mu"], self.sde.coeff_table(sample_steps, eta, self.device))
        predict = self._predictor(static, use_ema)

        def body():
            self.sde.step(state, predict)

        state.x.copy_(static["mu"])
        state.z.zero_()
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            body()
        caller.wait_stream(self._stream)
        before = kernel_launches("captured")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            body()
        after = kernel_launches("captured")
        self.captures += 1
        nets = self._step_nets(use_ema)
        return CompiledStep(graph, static, state, {k: after[k] - before[k] for k in after},
                            weights_version(nets),
                            packed_copies(p for net in nets for p in net.parameters()))
