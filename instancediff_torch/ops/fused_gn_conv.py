"""Fused GroupNorm-affine + SiLU + 3x3 convolution (+ bias, + residual).

Port of ``instancediff_tpu/ops/pallas_kernels.py:fused_gn_silu_conv3x3``
(Pallas kernel ``_fgc_kernel``) and of its statistics pass
``gn_channel_affine``. The statistics stay plain PyTorch (they are jnp in the
JAX package too). The CUDA kernel is ``csrc/fused_gn_silu_conv3x3.cu``;
``fused_gn_silu_conv3x3_plain`` is the same function in plain PyTorch. The
wrapper uses the plain version only for CPU tensors: for a CUDA tensor it
launches the kernel or raises."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .group_norm_silu import group_mean_rstd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gn_channel_affine(x, gamma, beta, num_groups, eps=1e-5):
    """Per-(B,C) coefficients with GN(x)*gamma+beta == x*scale + shift.
    x: [B,H,W,C]; float32 sum/sumsq over (H,W), then the group fold."""
    mean_c, rstd_c = group_mean_rstd(x, num_groups, eps)
    scale = rstd_c * gamma.float()[None]
    shift = beta.float()[None] - mean_c * scale
    return scale, shift


def fused_gn_silu_conv3x3_plain(x, scale_c, shift_c, w, bias_bc, residual=None):
    """y = conv3x3_SAME(SiLU(x*scale + shift)) + bias (+ residual).

    x [B,H,W,C]; scale_c/shift_c [B,C] f32; w [3,3,C,Cout] (HWIO); bias_bc
    [B,Cout] f32. The activation is rounded to x's dtype before the conv, the
    conv accumulates in float32 (bf16 products are exact in float32), and the
    result is stored in x's dtype."""
    xf = x.float() * scale_c[:, None, None, :] + shift_c[:, None, None, :]
    xn = (xf * torch.sigmoid(xf)).to(x.dtype)
    wk = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xn.float().permute(0, 3, 1, 2), wk, padding=1).permute(0, 2, 3, 1)
    y = y + bias_bc.float()[:, None, None, :]
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def fused_gn_silu_conv3x3(x, scale_c, shift_c, w, bias_bc, residual=None):
    """One-pass normalize+SiLU+3x3 conv (+bias[B,Cout], +residual).
    Any H, W, C and Cout; output [B,H,W,Cout] in x's dtype."""
    if x.device.type == "cpu":
        return fused_gn_silu_conv3x3_plain(x, scale_c, shift_c, w, bias_bc, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv3x3: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_gn_silu_conv3x3: dtype {x.dtype} not supported")
    B, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"fused_gn_silu_conv3x3: kernel {tuple(w.shape)} does "
                         f"not match input channels {C}")
    Cout = w.shape[3]
    if tuple(scale_c.shape) != (B, C) or tuple(shift_c.shape) != (B, C) \
            or tuple(bias_bc.shape) != (B, Cout):
        raise ValueError("fused_gn_silu_conv3x3: scale/shift must be [B,C] and "
                         "bias [B,Cout]")
    if residual is not None and (tuple(residual.shape) != (B, H, W, Cout)
                                 or residual.dtype != x.dtype):
        raise ValueError("fused_gn_silu_conv3x3: residual must be [B,H,W,Cout] "
                         "in x's dtype")
    tensors = [x, scale_c, shift_c, w, bias_bc] + ([residual] if residual is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_gn_silu_conv3x3: inputs on different devices")
    x = x.contiguous()
    scale_c = scale_c.float().contiguous()
    shift_c = shift_c.float().contiguous()
    w = w.to(x.dtype).contiguous()
    bias_bc = bias_bc.float().contiguous()
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _build.load("fused_gn_silu_conv3x3")
    rc = lib.fgc_forward(x.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr(),
                         w.data_ptr(), bias_bc.data_ptr(),
                         residual.data_ptr() if residual is not None else None,
                         out.data_ptr(), B, H, W, C, Cout, _DTYPES[x.dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "fused_gn_silu_conv3x3")
    fused_gn_silu_conv3x3.launches += 1
    return out


fused_gn_silu_conv3x3.launches = 0
