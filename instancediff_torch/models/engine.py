"""What the sampling engines share (``drift_model.CLIPDriftEngine`` and
``ddpm_model.CLIPDDPMEngine``): the device, the engine knobs, the
artifact-type map, and the frozen CLIP text tower with the prompts' token
ids."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..device import resolve_device
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
