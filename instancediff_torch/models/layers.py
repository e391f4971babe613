"""Small layers shared by the port's models, with flax's numerics.

Linear/Conv modules compute in their compute dtype (``cast_compute_``):
the sampling engines hold their weights in it, the trained nets hold float32
master weights and cast them where they are used, as flax's ``dtype=bf16``
modules do with their float32 parameters. Normalisation parameters stay
float32 and their math runs in float32, as the JAX modules'
``dtype=jnp.float32`` norms do."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def compute_dtype(m: nn.Module) -> torch.dtype:
    """The dtype ``m`` computes in: the one ``cast_compute_`` set, else its
    weight's."""
    return getattr(m, "compute_dtype", None) or m.weight.dtype


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to the compute
    dtype."""
    dt = compute_dtype(lin)
    return F.linear(x.to(dt), lin.weight.to(dt), _cast(lin.bias, dt))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: float32 math and output."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def conv_same(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` on NHWC. SAME pads (total//2,
    total - total//2): a stride-2 3x3 conv on an even size pads (0, 1), where
    torch's ``padding=1`` would pad (1, 1)."""
    B, H, W, C = x.shape
    kh, kw = conv.kernel_size
    pads = []
    for size, k in ((W, kw), (H, kh)):  # F.pad order: last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    dt = compute_dtype(conv)
    xc = F.pad(x.to(dt).permute(0, 3, 1, 2), pads)
    return F.conv2d(xc, conv.weight.to(dt), _cast(conv.bias, dt),
                    stride=stride).permute(0, 2, 3, 1)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv on NHWC as a matmul over the channel axis."""
    dt = compute_dtype(conv)
    return F.linear(x.to(dt), conv.weight[:, :, 0, 0].to(dt), _cast(conv.bias, dt))


def conv_transpose_same(x: torch.Tensor, up: nn.ConvTranspose2d) -> torch.Tensor:
    """flax ``nn.ConvTranspose(strides=2, padding="SAME")`` on NHWC at
    ``up``'s kernel size (the UNet's k=4, the dense ViT's necks' k=2; stride
    2 whatever stride the module was built with). flax
    correlates the s-dilated input, padded (a, b) by lax's SAME rule (a = k
    - 1 when s > k - 1, else ceil((k + s - 2) / 2); b = k + s - 2 - a), with
    the UNFLIPPED kernel; torch's transposed conv flips its kernel, so the
    converter stores the flax kernel flipped (utils/convert.py) and padding
    k - 1 - a here gives the same effective padding (k=4: (2, 2), padding 1;
    k=2: (1, 1), padding 0)."""
    k, s = up.kernel_size[0], 2
    a = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    if k + s - 2 - a != a or up.kernel_size[1] != k:
        raise ValueError(f"conv_transpose_same: kernel {up.kernel_size} at stride {s} "
                         "has no symmetric torch padding")
    dt = compute_dtype(up)
    y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), up.weight.to(dt),
                           _cast(up.bias, dt), stride=s, padding=k - 1 - a)
    return y.permute(0, 2, 3, 1)


class ConvParams(nn.Module):
    """Parameters of a 3x3 conv: ``weight`` is HWIO [3,3,Cin,Cout] (the fused
    kernel's layout, and flax's), ``bias`` [Cout]."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))


def conv3x3(x: torch.Tensor, conv: ConvParams) -> torch.Tensor:
    """flax ``nn.Conv((3,3), padding="SAME")`` on NHWC with the HWIO weight of
    ``conv``. Stride-1 SAME pads (1, 1), which is torch's ``padding=1``; the
    NCHW view of a contiguous NHWC tensor is already channels-last."""
    dt = compute_dtype(conv)
    w = conv.weight.to(dt).permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, _cast(conv.bias, dt), padding=1)
    return y.permute(0, 2, 3, 1)


def cast_compute_(module: nn.Module, dtype: torch.dtype, master: bool = False) -> nn.Module:
    """Set the compute dtype of every Linear/Conv/Embedding (and fused-conv
    parameter) module and cast its weights to it, or, with ``master``, keep
    them float32 (the trained nets' master weights, cast where they are used
    and updated by the optimizer in float32). Norms and free parameters keep
    float32 and are cast where they are used, as in the JAX modules."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Embedding,
                          ConvParams)):
            m.compute_dtype = dtype
            if not master:
                m.to(dtype)
    return module


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


# the submodules whose kernels flax initialises to zero: the ResBlocks'
# second conv, the output conv and the attention output projections
ZERO_INIT = ("conv2", "conv_out", "out")


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``module``'s Linear/Conv kernels from the JAX modules' initialiser
    (``lecun_normal`` over the flax kernel's fan-in), with the kernels of the
    submodules named in ``ZERO_INIT`` zero, as flax initialises them; biases
    zero. Norms, the SMM's free parameters and embeddings keep their
    constructors' values; an SMM context is drawn ~ N(0, 0.02), as flax's.
    The values are the port's own: torch cannot draw JAX's threefry bits."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, ConvParams)):
                w = m.weight
                if name.rsplit(".", 1)[-1] in ZERO_INIT:
                    w.zero_()
                elif isinstance(m, nn.ConvTranspose2d):  # [in, out, kh, kw]
                    _lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], generator)
                elif isinstance(m, ConvParams):  # HWIO
                    _lecun_normal_(w, w.shape[0] * w.shape[1] * w.shape[2], generator)
                else:  # [out, in, ...]
                    _lecun_normal_(w, w[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            context = getattr(m, "context", None)
            if isinstance(context, nn.Parameter):
                context.normal_(0.0, 0.02, generator=generator)
    return module
