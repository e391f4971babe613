"""GroupNorm (+ SiLU) over NHWC activations.

Port of ``instancediff_tpu/ops/pallas_kernels.py:group_norm_silu`` (Pallas
kernel ``_gns_kernel``). The CUDA kernel is ``csrc/group_norm_silu.cu``, two
launches: per-channel partial statistics over row chunks, then the fold to
group statistics and the normalise pass. ``group_norm_silu_plain`` is the
same function in plain PyTorch, with the numerics of
``group_norm_silu_reference``. The wrapper uses the plain version only for
CPU tensors: for a CUDA tensor it launches the kernel or raises."""

from __future__ import annotations

import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_mean_rstd(x, num_groups, eps=1e-5):
    """Per-(B,C) group mean and rstd of x [B,H,W,C]: float32 sum and sum of
    squares over (H,W) per channel, folded to groups, var = E[x^2] - mean^2."""
    B, H, W, C = x.shape
    G = num_groups
    Cg = C // G
    xf = x.float()
    colsum = xf.sum(dim=(1, 2))
    colsq = (xf * xf).sum(dim=(1, 2))
    n = H * W * Cg
    mean_g = colsum.reshape(B, G, Cg).sum(-1) / n
    var_g = colsq.reshape(B, G, Cg).sum(-1) / n - mean_g**2
    mean_c = mean_g.repeat_interleave(Cg, dim=1)
    rstd_c = torch.rsqrt(var_g + eps).repeat_interleave(Cg, dim=1)
    return mean_c, rstd_c


def group_norm_silu_plain(x, gamma, beta, num_groups, eps=1e-5, silu=True):
    """((x - mean) * rstd) * gamma + beta, then SiLU if asked, all in float32
    and rounded once to x's dtype. x [B,H,W,C]; gamma/beta [C]."""
    mean_c, rstd_c = group_mean_rstd(x, num_groups, eps)
    out = (x.float() - mean_c[:, None, None, :]) * rstd_c[:, None, None, :]
    out = out * gamma.float() + beta.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _stat_chunks(hw: int, c: int) -> int:
    """Row chunks per image for the kernel: about 16K elements each, but at
    most sqrt(HW/16), so that the apply pass's fold of the chunks' partials
    reads about an eighth of the bytes its rows do."""
    return max(1, min(-(-hw * c // 16384), math.isqrt(hw // 16)))


def group_norm_silu(x, gamma, beta, num_groups, eps=1e-5, silu=True):
    """Fused GroupNorm (+ SiLU). x [B,H,W,C] float32 or bfloat16, any B, H, W
    and any C with C % num_groups == 0; gamma/beta [C]. Output in x's dtype."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu: x must be [B,H,W,C], got {tuple(x.shape)}")
    B, H, W, C = x.shape
    G = int(num_groups)
    if G <= 0 or C % G:
        raise ValueError(f"group_norm_silu: {C} channels do not split into {G} groups")
    if tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,):
        raise ValueError("group_norm_silu: gamma and beta must be [C]")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("group_norm_silu: inputs on different devices")
    x = x.contiguous()
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    HW = H * W
    chunks = _stat_chunks(HW, C)
    partials = torch.empty((B, chunks, C, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load("group_norm_silu")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.gns_stats(x.data_ptr(), partials.data_ptr(), B, HW, C, chunks,
                       _DTYPES[x.dtype], stream)
    _build.check(rc, "group_norm_silu (statistics)")
    rc = lib.gns_apply(x.data_ptr(), partials.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                       out.data_ptr(), B, HW, C, G, chunks, float(eps), int(silu),
                       _DTYPES[x.dtype], stream)
    _build.check(rc, "group_norm_silu")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
