"""Fused GroupNorm-affine + SiLU + 3x3 convolution (+ bias, + residual).

Port of ``instancediff_tpu/ops/pallas_kernels.py:fused_gn_silu_conv3x3``
(Pallas kernel ``_fgc_kernel``) and of its statistics pass
``gn_channel_affine`` (jnp in the JAX package), whose CUDA path is the
GroupNorm statistics kernel of ``csrc/group_norm_silu.cu``
(``group_norm_silu.group_norm_affine_cuda``). The conv's CUDA kernels are in
``csrc/fused_gn_silu_conv3x3.cu``:
bf16 on the tensor cores (``fgc_tc_forward``, launched with the plan of
``conv_plan`` on weights packed by ``pack_weights`` once per parameter) and
fp32 in full fp32 (``fgc_fma_forward``). ``fused_gn_silu_conv3x3_plain`` and
``gn_channel_affine_plain`` are the same functions in plain PyTorch. The
wrappers use the plain versions only for CPU tensors: for a CUDA tensor they
launch a kernel or raise."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build
from .group_norm_silu import group_mean_rstd, group_norm_affine_cuda

# The bf16 kernel's launch plan, mirrored from csrc/fused_gn_silu_conv3x3.cu:
# TH x 8 pixel tiles (16x8 or 8x8: two warpgroups or one), 32-channel K
# slices, N blocks of NB output channels from NB_CHOICES, a ring of weight
# stages in shared memory.
TILES = ((16, 8), (8, 8))
SLICE = 32
NB_CHOICES = (8, 64, 128, 256)  # the kernel's wgmma widths; 8 serves the Cout=5 head
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use
N_SMS = 132
STAGES = 4


def _cdiv(a, b):
    return -(-a // b)


def tc_smem_bytes(th, nb, stages):
    """Shared memory of one bf16 block: the weight ring, two normalised halo
    tiles and two raw halos ((th+2) x 10 pixels x 32 channels each), two sets
    of scale/shift, one mbarrier per stage."""
    return stages * SLICE * nb * 2 + 4 * (th + 2) * 10 * SLICE * 2 + 4 * SLICE * 4 + stages * 8


@functools.lru_cache(maxsize=None)
def conv_plan(B, H, W, C, Cout):
    """Launch plan of the bf16 kernel for one input shape: tile ``th`` x
    ``tw``, N block ``nb`` (from ``NB_CHOICES``: multiples of 8 up to 256)
    and their count ``n_blocks``, weight ``stages``, the halo ``load`` path
    ("cp.async" needs C*2 bytes to be a multiple of 16; "scalar" otherwise),
    ``smem`` bytes and ``blocks``, the (tile, N block) work items. The kernel
    is persistent: it runs as many blocks at once as fit on the card, each
    walking several tiles. One N block covers Cout <= 256, so each
    activation is normalised once; the preferred tile comes first while the
    work items still give each of the card's 132 SMs one, then the 8x8
    tile, then narrower N blocks. Cached per shape: callers must not change
    the returned dict."""
    def cover(n):  # the narrowest choice >= n (256 past it: several N blocks)
        return next((c for c in NB_CHOICES if c >= n), NB_CHOICES[-1])

    def blocks(th, tw, nb):
        return B * _cdiv(H, th) * _cdiv(W, tw) * _cdiv(Cout, nb)

    nb = cover(Cout)
    # a 128-wide N block ran fastest on 8x8 tiles, every other width on 16x8
    # (``python3 chip_smoke.py --sweep`` on the H100, PERF.md)
    order = TILES[::-1] if nb == 128 else TILES
    th, tw = next((t for t in order if blocks(*t, nb) >= N_SMS), TILES[-1])
    split = 2
    while blocks(th, tw, nb) < N_SMS and nb > 64:
        nb = cover(_cdiv(Cout, split))
        split += 1
    return dict(th=th, tw=tw, nb=nb, n_blocks=_cdiv(Cout, nb), stages=STAGES,
                load="cp.async" if (C * 2) % 16 == 0 else "scalar",
                weights="tma_bulk", stage_bytes=SLICE * nb * 2,
                smem=tc_smem_bytes(th, nb, STAGES), blocks=blocks(th, tw, nb))


def pack_weights(w, nb):
    """HWIO [3,3,C,Cout] -> the bf16 kernel's layout
    [ceil(Cout/nb)][ceil(C/32)][9][nb][32], zero past C and Cout, each
    64-byte row of 32 input channels with its 16-byte chunks in the wgmma
    64-byte swizzle (chunk c of row n at c ^ ((n >> 1) & 3)): the weights of
    one (N block, slice, tap) step are one contiguous run of 32*nb*2 bytes,
    one TMA bulk copy, already in the layout the tensor cores read."""
    _, _, C, Cout = w.shape
    S, nbl = _cdiv(C, SLICE), _cdiv(Cout, nb)
    wp = w.new_zeros(3, 3, S * SLICE, nbl * nb)
    wp[:, :, :C, :Cout] = w
    wp = wp.reshape(9, S, SLICE // 8, 8, nbl, nb).permute(4, 1, 0, 5, 2, 3)  # nbl,S,9,nb,chunk,8
    n = torch.arange(nb, device=w.device)
    src = torch.arange(SLICE // 8, device=w.device)[None, :] ^ ((n[:, None] >> 1) & 3)
    wp = wp[:, :, :, n[:, None], src]  # position d of row n holds chunk d ^ ((n >> 1) & 3)
    return wp.reshape(nbl, S, 9, nb, SLICE).contiguous()


def packed_weights(w, nb):
    """``pack_weights`` of ``w`` in bf16, packed once per parameter: the copy is kept
    on the weight tensor itself (attribute ``_fgc_packed``, freed with it) and
    repacked when the tensor is updated in place. Inference tensors (made
    inside ``torch.inference_mode``, e.g. a cast of the caller's weight) keep
    no copy, so a CUDA graph capturing one would repack at every replay: that
    raises. The engines pass the parameter itself (bf16, or a trained net's
    float32 master weight: the copy is bf16 either way) and pack it in the
    warm-up step before the capture."""
    if w.is_inference():
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_gn_silu_conv3x3: an inference-mode weight would be "
                               "repacked at every replay of the captured graph")
        return pack_weights(w.to(torch.bfloat16), nb)
    key = (nb, w._version, w.data_ptr())
    hit = getattr(w, "_fgc_packed", None)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, pack_weights(w.detach().to(torch.bfloat16), nb))
        w._fgc_packed = hit
    return hit[1]


def packed_copies(params) -> list:
    """The packed copies ``packed_weights`` holds for ``params`` (those packed
    so far). A CUDA graph reads its copies by address, and a repack after an
    in-place update drops the parameter's reference, so the graph's owner
    keeps this list."""
    return [p._fgc_packed[1] for p in params if getattr(p, "_fgc_packed", None) is not None]


def gn_channel_affine_plain(x, gamma, beta, num_groups, eps=1e-5):
    """Per-(B,C) coefficients with GN(x)*gamma+beta == x*scale + shift.
    x: [B,H,W,C]; float32 sum/sumsq over (H,W), then the group fold."""
    mean_c, rstd_c = group_mean_rstd(x, num_groups, eps)
    scale = rstd_c * gamma.float()[None]
    shift = beta.float()[None] - mean_c * scale
    return scale, shift


def gn_channel_affine(x, gamma, beta, num_groups, eps=1e-5):
    """(scale, shift), float32 [B, C] each, with GN(x)*gamma+beta ==
    x*scale + shift; x [B,H,W,C] float32 or bfloat16, C % num_groups == 0."""
    if x.device.type == "cpu":
        return gn_channel_affine_plain(x, gamma, beta, num_groups, eps)
    _build.refuse_autograd("gn_channel_affine", x, gamma, beta)
    out = group_norm_affine_cuda(x, gamma, beta, num_groups, eps)
    _build.count_launch(gn_channel_affine)
    return out


gn_channel_affine.launches = gn_channel_affine.captured = 0


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
    _build.refuse_autograd("fused_gn_silu_conv3x3", x, scale_c, shift_c, w, bias_bc, residual)
    if x.dtype not in (torch.float32, torch.bfloat16):
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
    bias_bc = bias_bc.float().contiguous()
    residual = residual.contiguous() if residual is not None else None
    res_ptr = residual.data_ptr() if residual is not None else None
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _build.load("fused_gn_silu_conv3x3")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        plan = conv_plan(B, H, W, C, Cout)
        wpk = packed_weights(w, plan["nb"])  # in bf16, from w in its own dtype
        rc = lib.fgc_tc_forward(x.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr(),
                                wpk.data_ptr(), bias_bc.data_ptr(), res_ptr, out.data_ptr(),
                                B, H, W, C, Cout, plan["th"], plan["nb"], plan["stages"],
                                stream)
    else:
        w = w.float().contiguous()
        rc = lib.fgc_fma_forward(x.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr(),
                                 w.data_ptr(), bias_bc.data_ptr(), res_ptr, out.data_ptr(),
                                 B, H, W, C, Cout, stream)
    _build.check(rc, "fused_gn_silu_conv3x3")
    _build.count_launch(fused_gn_silu_conv3x3)
    return out


fused_gn_silu_conv3x3.launches = fused_gn_silu_conv3x3.captured = 0
