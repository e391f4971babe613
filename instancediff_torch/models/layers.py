"""Small layers shared by the port's models, with flax's numerics.

Linear/Conv modules hold their weights in the compute dtype; normalisation
parameters stay float32 and their math runs in float32, as the JAX modules'
``dtype=jnp.float32`` norms do."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: cast the input to the weights' dtype."""
    return lin(x.to(lin.weight.dtype))


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
    xc = F.pad(x.to(conv.weight.dtype).permute(0, 3, 1, 2), pads)
    return F.conv2d(xc, conv.weight, conv.bias, stride=stride).permute(0, 2, 3, 1)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv on NHWC as a matmul over the channel axis."""
    return F.linear(x.to(conv.weight.dtype), conv.weight[:, :, 0, 0], conv.bias)


def conv_transpose_same(x: torch.Tensor, up: nn.ConvTranspose2d) -> torch.Tensor:
    """flax ``nn.ConvTranspose(k=4, s=2, padding="SAME")`` on NHWC. flax
    correlates the 2x-dilated input, padded (2, 2), with the UNFLIPPED
    kernel; torch's transposed conv flips its kernel, so the converter stores
    the flax kernel flipped (utils/convert.py) and padding=1 here gives the
    same (2, 2) effective padding."""
    y = F.conv_transpose2d(x.to(up.weight.dtype).permute(0, 3, 1, 2), up.weight,
                           up.bias, stride=2, padding=1)
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
    w = conv.weight.permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w, conv.bias, padding=1)
    return y.permute(0, 2, 3, 1)


def cast_compute_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every Linear/Conv/Embedding (and fused-conv
    parameter) module to the compute dtype; norms and free parameters keep
    float32 and are cast where they are used, as in the JAX modules."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d, nn.Embedding,
                          ConvParams)):
            m.to(dtype)
    return module
