"""Blockwise-softmax attention for the UNet bottleneck and the ViT tower.

Port of ``instancediff_tpu/ops/pallas_kernels.py:flash_attention`` (Pallas
kernel ``_flash_kernel``), which takes any head width. The CUDA kernels are
in ``csrc/flash_attention.cu``, all on the tensor cores (mma.sync) at every
head width of ``HEAD_WIDTHS``: bf16 and fp16 (one kernel template over the
16-bit type; the softmax weights are rounded to that type before they
multiply V, the one departure from the all-fp32 Pallas kernel) and fp32 in
split TF32 (three TF32 products per fp32 product, fp32 accuracy);
``flash_plan`` picks one. ``multi_head_flash`` splits [B, N, C] into heads
around it, as the towers' unmasked self-attention needs.
``flash_attention_plain`` is the same function in plain PyTorch. The wrapper uses the plain version only for CPU
tensors: for a CUDA tensor it launches a kernel or raises; it raises when an
input requires grad and gradients are on (the kernel has no backward)."""

from __future__ import annotations

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_NAMES = "float32, bfloat16 or float16, all equal"
# the head widths the kernels are instantiated for (``flash_forward`` in the
# source): the UNet bottleneck's 4 heads give D = nf * ch_mult[-1] / 4; the
# towers' heads are 64 wide, coca_ViT-L-14's attentional pooler's 96
HEAD_WIDTHS = (4, 8, 16, 32, 64, 96, 128)
_PATHS = {"tc": 1, "tf32x3": 2}


def flash_plan(D: int, dtype: torch.dtype, N: int = 1024) -> dict:
    """The kernel that serves head width ``D`` in ``dtype`` for ``N`` query
    rows, mirrored from ``flash_forward`` in ``csrc/flash_attention.cu``:
    ``path`` "tc" (bf16 or fp16, ``flash_tc_kernel``, 8 warps) or "tf32x3"
    (fp32 in split TF32, ``flash_tf32x3_kernel``), all on the tensor cores at every
    width of ``HEAD_WIDTHS``; ``warps`` per block (16 query rows each): the
    fp32 kernel takes 8 unless 64-row blocks of 4 warps pad N to over a
    tenth fewer rows. Raises for a width or dtype no kernel takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype} not supported ({_DTYPE_NAMES})")
    if int(D) not in HEAD_WIDTHS:
        raise ValueError(f"flash_attention: head width D={D} has no kernel; the kernels "
                         f"take D in {HEAD_WIDTHS}")
    if dtype != torch.float32:
        return {"path": "tc", "D": int(D), "dtype": dtype, "warps": 8}
    # 8 warps (128-row blocks) ran faster per row; 4 where they pad N by
    # over a tenth more rows than 64-row blocks (N = 257: 384 against 320)
    # (``python3 chip_smoke.py --sweep flash``)
    warps = 8 if -(-N // 128) * 128 <= 1.1 * (-(-N // 64) * 64) else 4
    return {"path": "tf32x3", "D": int(D), "dtype": dtype, "warps": warps}


def flash_attention_plain(q, k, v, scale=None):
    """softmax(q k^T * scale) v over [B, H, N, D], all in float32 (the
    Pallas kernel upcasts q/k/v); output in q's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


def flash_attention(q, k, v, scale=None):
    """Unmasked attention. q/k/v: [B, H, N, D] (N ragged is fine; on CUDA D
    one of ``HEAD_WIDTHS``, the kernel chosen by ``flash_plan``). Output
    [B, H, N, D] in q's dtype."""
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
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported ({_DTYPE_NAMES})")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    B, H, N, D = q.shape
    plan = flash_plan(D, q.dtype, N)
    scale = D**-0.5 if scale is None else float(scale)
    q, k, v = (_build.aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    rc = lib.flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           B * H, N, k.shape[2], D, scale, _DTYPES[q.dtype],
                           _PATHS[plan["path"]], plan["warps"],
                           torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = flash_attention.captured = 0


def multi_head_flash(q, k, v, heads: int):
    """Unmasked multi-head attention on ``flash_attention``: q/k/v [B, N, C]
    split into ``heads`` heads of C // heads, attended, merged back to
    [B, N, C]."""
    B, N, C = q.shape

    def split(t):
        return t.reshape(B, t.shape[1], heads, C // heads).transpose(1, 2)

    out = flash_attention(split(q), split(k), split(v))
    return out.transpose(1, 2).reshape(B, N, C)
