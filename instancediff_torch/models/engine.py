"""What the sampling engines share (``drift_model.CLIPDriftEngine`` and
``ddpm_model.CLIPDDPMEngine``): the device, the engine knobs, the
artifact-type map, the frozen CLIP text tower with the prompts' token ids,
and the sampler call ``test`` with its compiled form.

The compiled sampler is the port's ``jax.jit`` of the JAX engines' ``lax.scan``
(``instancediff_tpu/models/drift_model.py:794-804``): on CUDA, ``test``
captures ONE sampler step in a ``torch.cuda.CUDAGraph`` per cache key (batch
shape, steps, eta, EMA, contexts) and replays it once per step. What a call
brings (the degraded input, type ids, image context, text encodings) is
copied into the graph's static buffers; the initial noise and each step's
noise are drawn from the caller's generator outside the graph, in the eager
loop's order, so the graph and the eager loop consume the same numbers. The
nets' weights are read by address too, so a graph is captured anew when
they have been updated in place since its capture."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.fused_gn_conv import fused_gn_silu_conv3x3, gn_channel_affine, packed_copies
from ..ops.group_norm_silu import group_norm_silu
from ..sde.schedules import strided_sampling_grid
from ..sde.stepping import SamplerState, run_steps
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


class SamplingEngine:
    """Base of the sampling engines.

    ``engine_opts`` takes the JAX engines' knobs. ``fused_gnconv`` is read by
    the drift engine; every other knob is accepted and changes nothing here:
    on CUDA the port always runs its GroupNorm and flash-attention kernels
    (``pallas_gn``, ``flash_mid``), and the TPU layout rewrites (``packed_l0``
    and the rest) are not ported. In JAX each of these knobs picks between
    value-identical graphs, so ignoring one changes no output."""

    def __init__(self, context_dim: int, CLIP_Type: str, artifact_prompts: Sequence[str],
                 type_map_ind: Optional[Dict[str, int]], engine_opts: Optional[Dict],
                 dtype: torch.dtype, tokenizer_vocab_path: Optional[str],
                 tiny_text_encoder: bool, device):
        self.device = resolve_device(device)
        if CLIP_Type != "CLIP":
            raise NotImplementedError(f"CLIP_Type {CLIP_Type!r} is not ported "
                                      "(only 'CLIP')")
        self.engine_opts = dict(engine_opts or {})
        unknown = sorted(set(self.engine_opts) - ENGINE_KNOBS)
        if unknown:
            raise KeyError(f"unknown engine knob {unknown[0]!r}; valid: {sorted(ENGINE_KNOBS)}")
        self.dtype = dtype
        self.context_dim = context_dim
        self.num_prompts = len(artifact_prompts)
        self.type_map = dict(type_map_ind) if type_map_ind else {
            name: i for i, name in enumerate(artifact_prompts)}
        text, self.token_embed_dim = build_text_encoder(context_dim, tiny=tiny_text_encoder)
        tok = ClipBPETokenizer(tokenizer_vocab_path, context_length=text.context_length,
                               vocab_size=text.vocab_size)
        self.prompt_ids = torch.from_numpy(tok(list(artifact_prompts))).to(self.device)
        self.text_encoder = cast_compute_(text.to(self.device), dtype).eval()
        # the compiled sampler: graphs by ``graph_key``, captures so far, the
        # graph the last compiled call replayed, and (made at the first
        # capture) the one memory pool all of the engine's graphs share and
        # the stream they are captured on
        self.graphs: Dict[tuple, CompiledStep] = {}
        self.captures = 0
        self.last_graph: Optional[CompiledStep] = None
        self._pool = None
        self._stream = None

    def _build_unet(self, settings: Dict, **kw) -> LearnableForwardUNetMultiScoreMap:
        """One UNet from a ``net_settings`` block, in the compute dtype on the
        engine's device; ``kw`` gives the engine-level fields."""
        s = dict(settings)
        net = LearnableForwardUNetMultiScoreMap(
            in_nc=s.get("in_nc", 2), out_nc=s.get("out_nc", 5), nf=s.get("nf", 64),
            ch_mult=tuple(s.get("ch_mult", (1, 2, 4, 4))),
            context_dim=s.get("context_dim", 512),
            text_module=s.get("text_module", "scoremap"),
            score_map_chan=s.get("score_map_chan", 16),
            token_embed_dim=self.token_embed_dim,
            num_res_blocks=s.get("num_res_blocks", 2), num_prompts=self.num_prompts, **kw)
        return cast_compute_(net.to(self.device), self.dtype).eval()

    def _encode_prompts(self, net) -> list:
        """Per-SMM [K, context_dim] text encodings for one net's contexts."""
        return [self.text_encoder(self.prompt_ids, ctx) for ctx in net.smm_contexts()]

    def _tensor(self, value, dtype):
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def _image_context(self, batch, B: int):
        """``batch["A_emb"]`` [B,1,context_dim] (zeros when absent), or None
        without image context."""
        if not self.use_image_context:
            return None
        a_emb = batch.get("A_emb")
        return (torch.zeros(B, 1, self.context_dim, device=self.device)
                if a_emb is None else self._tensor(a_emb, torch.float32))

    # ------------------------------------------------------------ sampling
    # An engine provides ``_inputs(batch, use_ema)``: a dict of the call's
    # tensors (``mu``, ``type_idx``, ``img_ctx``, ``degra_ctx`` and the text
    # encodings, None where absent), ``_predictor(inputs, use_ema)``:
    # ``predict(x, row)`` for ``sde.step``, reading only those tensors, and
    # ``_step_nets(use_ema)``: the nets that ``predict`` runs.

    @torch.inference_mode()
    def test(self, batch, generator: Optional[torch.Generator] = None, use_ema: bool = True,
             sample_steps: Optional[int] = None, eta: Optional[float] = None,
             init_noise: Optional[torch.Tensor] = None,
             step_noise: Optional[Sequence[torch.Tensor]] = None,
             compiled: Optional[bool] = None) -> torch.Tensor:
        """Restore a batch: ``batch["input"]`` [B,H,W,1] in [-1,1] (the
        degraded image mu), ``batch["type_idx"]`` [B], optional
        ``batch["A_emb"]`` [B,1,context_dim] (zeros when absent; used with
        image context). Returns x0_hat [B,H,W,1] float32 on the engine's
        device. Noise comes from ``generator`` unless ``init_noise`` and
        ``step_noise`` are given (see ``stepping.run_steps``).

        ``compiled`` (default: True on CUDA, False on the CPU) replays one
        captured graph per sampler step, captured at the first call of each
        ``graph_key`` and cached on the engine (captured anew when the
        nets' weights changed since); False runs the same step eagerly, one
        launch per kernel (JAX without ``jit``). A failed capture or replay
        raises; there is no fallback to the eager loop."""
        if self.sde is None:
            raise ValueError("engine has no SDE; pass sde= to the constructor")
        if compiled is None:
            compiled = self.device.type == "cuda"
        elif compiled and self.device.type != "cuda":
            raise ValueError("compiled=True captures a CUDA graph; this engine lives on "
                             f"{self.device} (pass compiled=False)")
        with record_function("sampler_inputs"):
            inputs = self._inputs(batch, use_ema)
        if not compiled:
            return self.sde.reverse_ddpm(
                inputs["mu"], self._predictor(inputs, use_ema), eta=eta,
                sample_steps=sample_steps, generator=generator, init_noise=init_noise,
                step_noise=step_noise)
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
        return entry.state.x.clone()

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
