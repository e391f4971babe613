"""Blockwise-softmax attention for the UNet bottleneck.

Port of ``instancediff_tpu/ops/pallas_kernels.py:flash_attention`` (Pallas
kernel ``_flash_kernel``). The CUDA kernels are in ``csrc/flash_attention.cu``:
bf16 on the tensor cores (mma.sync; the softmax weights are rounded to bf16
before they multiply V, the one departure from the all-fp32 Pallas kernel)
and fp32 on the FMA units. ``flash_attention_plain`` is the same function in
plain PyTorch. The wrapper uses the plain version only for CPU tensors: for a
CUDA tensor it launches a kernel or raises; it raises when an input requires
grad and gradients are on (the kernel has no backward)."""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, scale=None):
    """softmax(q k^T * scale) v over [B, H, N, D], all in float32 (the
    Pallas kernel upcasts q/k/v); output in q's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


def flash_attention(q, k, v, scale=None):
    """Unmasked attention. q/k/v: [B, H, N, D] (N ragged is fine; D must be
    64 on CUDA). Output [B, H, N, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16, all equal)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    B, H, N, D = q.shape
    if D != 64:
        raise NotImplementedError(f"flash_attention kernel supports D=64, got {D}")
    scale = D**-0.5 if scale is None else float(scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    rc = lib.flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           B * H, N, k.shape[2], D, scale, _DTYPES[q.dtype],
                           torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = flash_attention.captured = 0
