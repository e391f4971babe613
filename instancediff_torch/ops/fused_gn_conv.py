"""Fused GroupNorm-affine + SiLU + 3x3 convolution (+ bias, + residual).

Port of ``instancediff_tpu/ops/pallas_kernels.py:fused_gn_silu_conv3x3``
(Pallas kernel ``_fgc_kernel``) and of its statistics pass
``gn_channel_affine`` (jnp in the JAX package), whose CUDA path is the
GroupNorm statistics kernel of ``csrc/group_norm_silu.cu``
(``group_norm_silu.group_norm_affine_cuda``). The conv's CUDA kernels are in
``csrc/fused_gn_silu_conv3x3.cu``:
both on the tensor cores, launched with the plan of ``conv_plan`` on weights
packed once per parameter (``packed_weights``): bf16 on wgmma
(``fgc_tc_forward``, ``pack_weights``) and fp32 in split TF32 on mma.sync
(``fgc_tf32_forward``, ``pack_weights_tf32x3``: three TF32 products per fp32
product, fp32 accuracy). ``fused_gn_silu_conv3x3_plain`` and
``gn_channel_affine_plain`` are the same functions in plain PyTorch. The
wrappers use the plain versions only for CPU tensors: for a CUDA tensor they
launch a kernel or raise.

Over an image split by rows across the ranks of a
``parallel.spatial.SpatialGroup`` (``sp``), the fused body takes its
GroupNorm statistics across the shards (``group_norm_silu.
gn_affine_sharded``) and ``fused_gn_silu_conv3x3_sharded`` runs the conv on ``[top halo; rows; bottom halo]`` with its first and last
output rows cropped; the kernel applies the global scale and shift to the
halo rows too and pads with zeros after SiLU only at the image's own edges,
where a shard takes no halo, so the result is the unsharded conv's."""

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
# The fp32 kernel's plan: 8x16 pixel tiles, 32-channel K slices, N blocks
# from NB_CHOICES_F32, a ring of F32_STAGES weight stages (one per tap step)
F32_TILE = (8, 16)
NB_CHOICES_F32 = (8, 16, 32, 64, 128)
F32_STAGES = 3


def _cdiv(a, b):
    return -(-a // b)


def tc_smem_bytes(th, nb, stages):
    """Shared memory of one bf16 block: the weight ring, two normalised halo
    tiles and two raw halos ((th+2) x 10 pixels x 32 channels each), two sets
    of scale/shift, one mbarrier per stage."""
    return stages * SLICE * nb * 2 + 4 * (th + 2) * 10 * SLICE * 2 + 4 * SLICE * 4 + stages * 8


def tf32_smem_bytes(nb):
    """Shared memory of one fp32 block: the raw halo (10 x 18 pixels x 32
    channels) and its scale/shift, the normalised halo's big and small
    halves (rows of 36 floats), and the weight ring (``F32_STAGES`` stages
    of big and small [nb][36])."""
    halo = (F32_TILE[0] + 2) * (F32_TILE[1] + 2)
    return (halo * SLICE + 2 * SLICE + 2 * halo * (SLICE + 4)
            + F32_STAGES * 2 * nb * (SLICE + 4)) * 4


def _conv_plan_f32(B, H, W, C, Cout):
    th, tw = F32_TILE
    tiles = B * _cdiv(H, th) * _cdiv(W, tw)
    # the narrowest N block that covers Cout, 128 past it: at 32x32 and
    # 28x28 px, Cout 256, two 128-wide blocks ran faster than four 64-wide
    # ones though they leave SMs idle (``python3 chip_smoke.py --sweep
    # conv`` on the H100); Cout = 5 pays for 8 columns
    nb = next((c for c in NB_CHOICES_F32 if c >= Cout), NB_CHOICES_F32[-1])
    return dict(kernel="tf32x3", th=th, tw=tw, nb=nb, n_blocks=_cdiv(Cout, nb),
                stages=F32_STAGES, load="cp.async" if C % 4 == 0 else "scalar",
                weights="cp.async", stage_bytes=2 * SLICE * nb * 4, smem=tf32_smem_bytes(nb),
                blocks=tiles * _cdiv(Cout, nb))


@functools.lru_cache(maxsize=None)
def conv_plan(B, H, W, C, Cout, dtype=torch.bfloat16):
    """Launch plan of the kernel for one input shape and dtype. fp32
    (``kernel`` "tf32x3"): 8 x 16 tiles, the narrowest N block of
    ``NB_CHOICES_F32`` that covers Cout (128-wide blocks past it); the
    halo ``load`` path is "cp.async" (16-byte chunks) when C % 4 == 0,
    "scalar" otherwise. bf16 (``kernel`` "tc"): tile ``th`` x
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
    if dtype == torch.float32:
        return _conv_plan_f32(B, H, W, C, Cout)
    if dtype != torch.bfloat16:
        raise TypeError(f"conv_plan: dtype {dtype} not supported")

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
    return dict(kernel="tc", th=th, tw=tw, nb=nb, n_blocks=_cdiv(Cout, nb), stages=STAGES,
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


def split_tf32(x):
    """fp32 ``x`` as (big, small), both TF32 (fp32 with the low 13 mantissa
    bits zero): big = x rounded to nearest, ties away from zero
    (``cvt.rna.tf32.f32``), small = the remainder rounded the same way.
    big + small carries x to ~2^-22 relative."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)  # & 0xFFFFE000

    big = rna(x.float())
    return big, rna(x.float() - big)


def pack_weights_tf32x3(w, nb):
    """HWIO [3,3,C,Cout] -> the fp32 kernel's layout
    [ceil(Cout/nb)][ceil(C/32)][9][2][nb][32] float32: each weight's TF32
    big half at [..., 0, n, c] and small half at [..., 1, n, c], zero past
    C and Cout; one (N block, slice, tap) step is one contiguous run of
    2*nb*32 floats."""
    _, _, C, Cout = w.shape
    S, nbl = _cdiv(C, SLICE), _cdiv(Cout, nb)
    wp = w.new_zeros(3, 3, S * SLICE, nbl * nb, dtype=torch.float32)
    wp[:, :, :C, :Cout] = w.float()
    wp = wp.reshape(9, S, SLICE, nbl, nb).permute(3, 1, 0, 4, 2)  # nbl,S,9,nb,32
    return torch.stack(split_tf32(wp), dim=3).contiguous()


# the packed layout of each kernel's weights, by packing format
PACKERS = {"bf16": lambda w, nb: pack_weights(w.to(torch.bfloat16), nb),
           "tf32x3": pack_weights_tf32x3}


def packed_weights(w, nb, fmt="bf16"):
    """``w`` packed for the kernel of format ``fmt`` ("bf16": ``pack_weights``
    of w in bf16; "tf32x3": ``pack_weights_tf32x3`` of w in fp32), once per
    parameter and format: the copies are kept on the weight tensor itself
    (attribute ``_fgc_packed``, {fmt: (key, copy)}, freed with it) and
    repacked when the tensor is updated in place. A trained net's float32
    master weight may be packed in both formats in one process. Inference
    tensors (made inside ``torch.inference_mode``, e.g. a cast of the
    caller's weight) keep no copy, so a CUDA graph capturing one would
    repack at every replay: that raises. The engines pass the parameter
    itself and pack it in the warm-up step before the capture."""
    if w.is_inference():
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_gn_silu_conv3x3: an inference-mode weight would be "
                               "repacked at every replay of the captured graph")
        return PACKERS[fmt](w, nb)
    key = (nb, w._version, w.data_ptr())
    cache = getattr(w, "_fgc_packed", None)
    if cache is None:
        cache = w._fgc_packed = {}
    hit = cache.get(fmt)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[fmt] = (key, PACKERS[fmt](w.detach(), nb))
    return hit[1]


def packed_copies(params) -> list:
    """The packed copies ``packed_weights`` holds for ``params`` (those packed
    so far, every format). A CUDA graph reads its copies by address, and a
    repack after an in-place update drops the parameter's reference, so the
    graph's owner keeps this list."""
    return [copy for p in params for _, copy in getattr(p, "_fgc_packed", {}).values()]


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


def fused_gn_silu_conv3x3_sharded(x, scale_c, shift_c, w, bias_bc, residual=None, *, sp):
    """``fused_gn_silu_conv3x3`` of this rank's rows ``x`` of an image split
    over the ranks of ``sp``: one call on ``[top halo; x; bottom halo]``
    (each neighbour's nearest row; none at the image's own edges, where the
    kernel pads with zeros), the residual padded with zero rows to match, the
    halo rows' outputs cropped."""
    top, bottom = sp.halo(x, 1, 1)
    lo, hi = int(sp.rank > 0), int(sp.rank < sp.world - 1)
    xe = torch.cat([top] * lo + [x] + [bottom] * hi, dim=1)
    if residual is not None:
        pad = residual.new_zeros(residual.shape[0], 1, *residual.shape[2:])
        residual = torch.cat([pad] * lo + [residual] + [pad] * hi, dim=1)
    y = fused_gn_silu_conv3x3(xe, scale_c, shift_c, w, bias_bc, residual)
    return y[:, lo:y.shape[1] - hi]


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
    x = _build.aligned(x.contiguous())
    scale_c = scale_c.float().contiguous()
    shift_c = shift_c.float().contiguous()
    bias_bc = bias_bc.float().contiguous()
    residual = _build.aligned(residual.contiguous()) if residual is not None else None
    res_ptr = residual.data_ptr() if residual is not None else None
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    lib = _build.load("fused_gn_silu_conv3x3")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = conv_plan(B, H, W, C, Cout, x.dtype)
    if x.dtype == torch.bfloat16:
        wpk = packed_weights(w, plan["nb"], "bf16")  # in bf16, from w in its own dtype
        rc = lib.fgc_tc_forward(x.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr(),
                                wpk.data_ptr(), bias_bc.data_ptr(), res_ptr, out.data_ptr(),
                                B, H, W, C, Cout, plan["th"], plan["nb"], plan["stages"],
                                stream)
    else:
        wpk = packed_weights(w, plan["nb"], "tf32x3")  # TF32 halves of w in fp32
        rc = lib.fgc_tf32_forward(x.data_ptr(), scale_c.data_ptr(), shift_c.data_ptr(),
                                  wpk.data_ptr(), bias_bc.data_ptr(), res_ptr, out.data_ptr(),
                                  B, H, W, C, Cout, plan["nb"], stream)
    _build.check(rc, "fused_gn_silu_conv3x3")
    _build.count_launch(fused_gn_silu_conv3x3)
    return out


fused_gn_silu_conv3x3.launches = fused_gn_silu_conv3x3.captured = 0
