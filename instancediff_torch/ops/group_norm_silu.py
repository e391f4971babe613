"""GroupNorm (+ SiLU) over NHWC activations, and the GroupNorm statistics
of the fused ResBlock body.

Port of ``instancediff_tpu/ops/pallas_kernels.py:group_norm_silu`` (Pallas
kernel ``_gns_kernel``). The CUDA kernels are ``csrc/group_norm_silu.cu``:
either a statistics launch (per-group partial sums over row chunks, folded
once per image by the image's last block) and an apply launch, or, where one
image fits in the shared memory of a thread block cluster, one cluster launch
that reads x once. ``gn_plan`` mirrors the kernels' launch plan in plain
Python. The same statistics launch gives the fused body's per-(B,C) scale and
shift (``group_norm_affine_cuda``, behind ``fused_gn_conv.gn_channel_affine``).
``group_norm_silu_plain`` is the same function in plain PyTorch, with the
numerics of ``group_norm_silu_reference``.

An image split by rows over the ranks of a ``parallel.spatial.SpatialGroup``
(``sp``) takes the same GroupNorm in two halves: ``gn_partial_sums`` (the
statistics launch stopped before the group fold: per-(B,C) fp32 sum and sum
of squares), summed over the ranks and folded to groups in plain PyTorch
(``fold_mean_rstd``, as ``group_mean_rstd`` folds), then ``gn_apply``, which
normalises with a per-(B,C) scale and shift (``gn_affine_sharded``,
``group_norm_silu_sharded``). The wrappers use the plain versions only for
CPU tensors: for a CUDA tensor they launch the kernels or raise."""

from __future__ import annotations

import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The launch plan, mirrored from csrc/group_norm_silu.cu.
NT = 256  # threads per block
N_SMS = 132
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block may use
BLOCKS_PER_SM = 2  # the statistics and apply kernels' __launch_bounds__ minimum
# The cluster path: clusters of 8 blocks (portable; 16 fit only 7 clusters on
# the card at once, so 8 images took two waves) where one image has at most
# CLUSTER_MAX_BYTES, the sizes where it beat the two launches on the H100
# (``python3 chip_smoke.py --sweep gn``, PERF.md): the 32^2 levels up to 512
# channels and 64^2 at 128.
CLUSTER = 8
CLUSTER_MAX_BYTES = 1 << 20


def _cdiv(a, b):
    return -(-a // b)


def _layout(C, vec):
    """(V, RG, slots): vector columns, row groups per block, and the slots of
    the block reduction (one per warp where V is a power of two below 32 and
    the warps reduce their row groups by shuffles, else one per row group)."""
    V = C // vec
    RG = 1 if V >= NT else NT // V
    shfl = V < 32 and 32 % V == 0
    return V, RG, NT // 32 if shfl else RG


def stats_smem_bytes(C, G, vec):
    """Shared memory of one statistics block: per-slot and per-channel (sum,
    sumsq), per-group (sum, sumsq) and the fold's scratch, in fp32."""
    slots = _layout(C, vec)[2]
    return 4 * (slots * C * 2 + C * 2 + G * 2 + max(NT, G) * 2)


def cluster_smem_bytes(rows, C, G, vec, itemsize):
    """Shared memory of one cluster block: its rows of x (16-byte aligned),
    the block reduction and (mean, rstd) per group."""
    return -(-rows * C * itemsize // 16) * 16 + stats_smem_bytes(C, G, vec) + 4 * G * 2


@functools.lru_cache(maxsize=None)
def gn_plan(B, HW, C, G, itemsize=2, cluster=None):
    """Launch plan of the kernels for x [B, HW, C] with G groups and elements
    of ``itemsize`` bytes: the vector width ``vec`` (16 bytes where C allows,
    else 1 element) and the ``path`` of ``group_norm_silu``:
      "cluster"    where an image of at most ``CLUSTER_MAX_BYTES`` fits a
                   cluster of ``CLUSTER`` blocks: one launch of
                   ``cluster_blocks`` blocks of ``cluster_smem`` bytes;
      "two_launch" else: the statistics launch of ``blocks`` blocks of
                   ``rows`` rows (about ``BLOCKS_PER_SM`` per SM, at least one
                   row per row group; ``smem`` bytes each), then the apply
                   launch on the same grid.
    ``gn_channel_affine`` takes the statistics launch alone. ``scratch``: the
    fp32 words of group partials, then group mean / rstd. ``cluster`` forces
    a path (0: two launches; ``CLUSTER``: the cluster launch, which must
    fit), for tests and the sweep. Cached per shape: callers must not change
    the returned dict."""
    vec = 16 // itemsize if C % (16 // itemsize) == 0 else 1
    RG = _layout(C, vec)[1]
    chunks = max(1, min(_cdiv(BLOCKS_PER_SM * N_SMS, B), _cdiv(HW, RG)))
    rows = max(1, HW // chunks)  # rounded down, so the last chunk is the short one
    chunks = _cdiv(HW, rows)
    fits = cluster_smem_bytes(_cdiv(HW, CLUSTER), C, G, vec, itemsize) <= SMEM_LIMIT
    if cluster is None:
        cluster = CLUSTER if HW * C * itemsize <= CLUSTER_MAX_BYTES and fits else 0
    elif cluster not in (0, CLUSTER) or (cluster and not fits):
        raise ValueError(f"gn_plan: an image of {HW}x{C} does not fit a cluster of {cluster}")
    return dict(path="cluster" if cluster else "two_launch", vec=vec, rows=rows,
                blocks=B * chunks, cluster=cluster, cluster_blocks=B * cluster,
                smem=stats_smem_bytes(C, G, vec),
                cluster_smem=cluster_smem_bytes(_cdiv(HW, cluster), C, G, vec, itemsize)
                if cluster else 0,
                scratch=2 * B * chunks * G + 2 * B * G)


def gn_partial_sums_plain(x):
    """[2, B, C] float32: the sum and the sum of squares over (H, W) of each
    channel of x [B,H,W,C], in float32."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))])


def fold_mean_rstd(sums, num_groups, pixels, eps=1e-5):
    """Per-(B,C) group mean and rstd from per-channel ``sums`` [2, B, C] over
    ``pixels`` pixels: folded to groups, var = E[x^2] - mean^2."""
    _, B, C = sums.shape
    G = num_groups
    Cg = C // G
    n = pixels * Cg
    mean_g = sums[0].reshape(B, G, Cg).sum(-1) / n
    var_g = sums[1].reshape(B, G, Cg).sum(-1) / n - mean_g**2
    mean_c = mean_g.repeat_interleave(Cg, dim=1)
    rstd_c = torch.rsqrt(var_g + eps).repeat_interleave(Cg, dim=1)
    return mean_c, rstd_c


def group_mean_rstd(x, num_groups, eps=1e-5):
    """Per-(B,C) group mean and rstd of x [B,H,W,C]: float32 sum and sum of
    squares over (H,W) per channel, folded to groups, var = E[x^2] - mean^2."""
    B, H, W, C = x.shape
    return fold_mean_rstd(gn_partial_sums_plain(x), num_groups, H * W, eps)


def group_norm_silu_plain(x, gamma, beta, num_groups, eps=1e-5, silu=True):
    """((x - mean) * rstd) * gamma + beta, then SiLU if asked, all in float32
    and rounded once to x's dtype. x [B,H,W,C]; gamma/beta [C]."""
    mean_c, rstd_c = group_mean_rstd(x, num_groups, eps)
    out = (x.float() - mean_c[:, None, None, :]) * rstd_c[:, None, None, :]
    out = out * gamma.float() + beta.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _checked_x(name, x):
    """x checked for the kernels: contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B,H,W,C], got {tuple(x.shape)}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x  # the 16-byte loads need an aligned start


def _checked(name, x, gamma, beta, num_groups):
    """The kernels' inputs, checked: (x contiguous, B, H, W, C, G)."""
    x = _checked_x(name, x)
    B, H, W, C = x.shape
    G = int(num_groups)
    if G <= 0 or C % G:
        raise ValueError(f"{name}: {C} channels do not split into {G} groups")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"{name}: gamma and beta must be [C]")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"{name}: inputs on different devices")
    return x, B, H, W, C, G


def _current_stream(x):
    """The current CUDA stream of x's device as an int (the raw handle
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building a
    Stream object: a few microseconds of host time per call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


# per (device, stream): fp32 scratch words (group partials, group mean /
# rstd) and the int32 per-image tickets (zero at first, left zero by every
# call). Calls on one stream run in order, so they can share them.
#
# A CUDA graph keeps the addresses its launches were captured with. The
# engines capture on a stream of their own after one eager warm-up step on
# that stream (``models/engine.py:SamplingEngine._capture``), so the capture
# finds its stream's scratch already allocated and allocates nothing; a
# replay then reads that scratch from whatever stream it runs on, in order
# with the engine's other replays. A buffer outgrown later may still be
# read by a graph, so it is kept in ``_outgrown``, never freed.
_scratch: dict = {}
_outgrown: list = []


def _scratch_for(x, stream, floats, B):
    key = (x.device.index, stream)
    old = buf, tickets = _scratch.get(key, (None, None))
    if buf is None or buf.numel() < floats:
        n = 0 if buf is None else buf.numel()
        buf = torch.empty(max(floats, 2 * n, 1 << 16), dtype=torch.float32, device=x.device)
    if tickets is None or tickets.numel() < B:
        tickets = torch.zeros(max(B, 64), dtype=torch.int32, device=x.device)
    if buf is not old[0] or tickets is not old[1]:
        _outgrown.append(old)
        _scratch[key] = (buf, tickets)
    return buf, tickets


def group_norm_silu_cuda(x, gamma, beta, num_groups, eps=1e-5, silu=True, plan=None):
    """The CUDA kernels of ``group_norm_silu`` under ``plan`` (default
    ``gn_plan`` of the shape), with one call into the library; counts no
    launch. x on a CUDA device."""
    x, B, H, W, C, G = _checked("group_norm_silu", x, gamma, beta, num_groups)
    HW = H * W
    plan = plan or gn_plan(B, HW, C, G, x.element_size())
    out = torch.empty_like(x)
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()  # kept alive for the launch
    stream = _current_stream(x)
    buf, tickets = _scratch_for(x, stream, plan["scratch"], B)
    gstat = buf.data_ptr() + 4 * (plan["scratch"] - 2 * B * G)
    rc = _build.load("group_norm_silu").gns_forward(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        buf.data_ptr(), gstat, tickets.data_ptr(), B, HW, C, G, float(eps), int(silu),
        _DTYPES[x.dtype], plan["vec"], plan["rows"], plan["cluster"], stream)
    _build.check(rc, "group_norm_silu")
    return out


def group_norm_affine_cuda(x, gamma, beta, num_groups, eps=1e-5, plan=None):
    """The statistics launch alone, folded to the fused conv's per-(B,C)
    ``scale = rstd * gamma`` and ``shift = beta - mean * scale`` (float32
    [B, C] each); one call into the library, no launch counted."""
    x, B, H, W, C, G = _checked("gn_channel_affine", x, gamma, beta, num_groups)
    HW = H * W
    plan = plan or gn_plan(B, HW, C, G, x.element_size())
    out = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()  # kept alive for the launch
    stream = _current_stream(x)
    buf, tickets = _scratch_for(x, stream, plan["scratch"], B)
    rc = _build.load("group_norm_silu").gns_affine(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        buf.data_ptr(), tickets.data_ptr(), B, HW, C, G, float(eps), _DTYPES[x.dtype],
        plan["vec"], plan["rows"], stream)
    _build.check(rc, "gn_channel_affine")
    return out[0], out[1]


def group_norm_silu(x, gamma, beta, num_groups, eps=1e-5, silu=True):
    """Fused GroupNorm (+ SiLU). x [B,H,W,C] float32 or bfloat16, any B, H, W
    and any C with C % num_groups == 0; gamma/beta [C]. Output in x's dtype."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, gamma, beta, num_groups, eps, silu)
    _build.refuse_autograd("group_norm_silu", x, gamma, beta)
    out = group_norm_silu_cuda(x, gamma, beta, num_groups, eps, silu)
    _build.count_launch(group_norm_silu)
    return out


group_norm_silu.launches = group_norm_silu.captured = 0


def _plan_1(x):
    """The statistics plan of x [B,H,W,C] without groups: (B, HW, C, plan)."""
    B, H, W, C = x.shape
    return B, H * W, C, gn_plan(B, H * W, C, 1, x.element_size(), cluster=0)


def gn_partial_sums(x):
    """[2, B, C] float32: each channel's sum and sum of squares over (H, W)
    of x [B,H,W,C] float32 or bfloat16 (the statistics launch of
    ``gn_channel_affine`` without the group fold)."""
    if x.device.type == "cpu":
        return gn_partial_sums_plain(x)
    _build.refuse_autograd("gn_partial_sums", x)
    x = _checked_x("gn_partial_sums", x)
    B, HW, C, plan = _plan_1(x)
    out = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    floats = 2 * B * _cdiv(HW, plan["rows"]) * C
    stream = _current_stream(x)
    buf, tickets = _scratch_for(x, stream, floats, B)
    rc = _build.load("group_norm_silu").gns_partial_sums(
        x.data_ptr(), out.data_ptr(), buf.data_ptr(), tickets.data_ptr(), B, HW, C,
        _DTYPES[x.dtype], plan["vec"], plan["rows"], stream)
    _build.check(rc, "gn_partial_sums")
    _build.count_launch(gn_partial_sums)
    return out


gn_partial_sums.launches = gn_partial_sums.captured = 0


def gn_apply_plain(x, scale, shift, silu=True):
    """x * scale + shift (then SiLU if asked) with per-(B,C) float32 scale
    and shift [B, C], in float32, rounded once to x's dtype."""
    out = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def gn_apply(x, scale, shift, silu=True):
    """``gn_apply_plain`` on the GroupNorm apply kernel: x [B,H,W,C] float32
    or bfloat16, scale and shift [B, C] float32; output in x's dtype."""
    if x.device.type == "cpu":
        return gn_apply_plain(x, scale, shift, silu)
    _build.refuse_autograd("gn_apply", x, scale, shift)
    x = _checked_x("gn_apply", x)
    B, HW, C, plan = _plan_1(x)
    if tuple(scale.shape) != (B, C) or tuple(shift.shape) != (B, C) \
            or scale.device != x.device or shift.device != x.device:
        raise ValueError(f"gn_apply: scale and shift must be [B, C] = {(B, C)} on {x.device}")
    coefs = torch.stack([scale.float(), shift.float()]).contiguous()  # kept alive for the launch
    out = torch.empty_like(x)
    rc = _build.load("group_norm_silu").gns_apply_affine(
        x.data_ptr(), coefs.data_ptr(), out.data_ptr(), B, HW, C, int(silu), _DTYPES[x.dtype],
        plan["vec"], plan["rows"], _current_stream(x))
    _build.check(rc, "gn_apply")
    _build.count_launch(gn_apply)
    return out


gn_apply.launches = gn_apply.captured = 0


def gn_affine_sharded(x, gamma, beta, num_groups, eps, sp, plain=False):
    """GroupNorm's per-(B,C) ``scale = rstd * gamma`` and ``shift = beta -
    mean * scale`` (float32 [B, C] each) of an image whose rows are split
    over the ranks of ``sp`` (x: this rank's rows): the per-channel sums of
    each shard (``gn_partial_sums``; with ``plain`` its plain version),
    summed over the ranks, folded to groups over the whole image's pixels."""
    sums = (gn_partial_sums_plain if plain else gn_partial_sums)(x)
    sp.all_reduce_sum_(sums)
    B, H, W, C = x.shape
    mean_c, rstd_c = fold_mean_rstd(sums, num_groups, H * sp.world * W, eps)
    scale = rstd_c * gamma.float()[None]
    return scale, beta.float()[None] - mean_c * scale


def group_norm_silu_sharded(x, gamma, beta, num_groups, eps, silu, sp, plain=False):
    """``group_norm_silu`` of an image whose rows are split over the ranks of
    ``sp``: the statistics across the shards (``gn_affine_sharded``), then
    ``gn_apply`` on this rank's rows (with ``plain`` the plain versions)."""
    scale, shift = gn_affine_sharded(x, gamma, beta, num_groups, eps, sp, plain)
    return (gn_apply_plain if plain else gn_apply)(x, scale, shift, silu)
