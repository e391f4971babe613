"""The fused-conv kernels' launch plans and weight packing, on the CPU.

``conv_plan`` chooses the tile, the N block, the weight stages and the halo
load path of ``csrc/fused_gn_silu_conv3x3.cu`` in plain Python, for the bf16
kernel and for the fp32 (split-TF32) one; these tests
hold it to the kernel's limits at every fused-conv launch of the flagship
UNet forward (batch 8, at 256 px and at 224 px). Nothing here imports
triton or CUDA code, or JAX.
"""

import itertools

import pytest
import torch

from instancediff_torch.ops.fused_gn_conv import (
    N_SMS,
    NB_CHOICES,
    NB_CHOICES_F32,
    SMEM_LIMIT,
    conv_plan,
    pack_weights,
    packed_copies,
    packed_weights,
    tf32_smem_bytes,
)

# (H, W, C, Cout, launches) of one flagship drift UNet forward at 256 px:
# 22 ResBlocks x 2 convs and the output head (45 launches)
FLAGSHIP_256 = [
    (256, 256, 64, 64, 9), (256, 256, 64, 5, 1), (256, 256, 144, 64, 1),
    (128, 128, 64, 128, 1), (128, 128, 128, 128, 8), (128, 128, 272, 128, 1),
    (64, 64, 128, 256, 1), (64, 64, 256, 256, 8), (64, 64, 528, 256, 1),
    (32, 32, 256, 256, 13), (32, 32, 528, 256, 1)]
BATCH = 8


def _launches(res):
    k = res / 256
    return [(int(H * k), int(W * k), C, Cout) for H, W, C, Cout, _ in FLAGSHIP_256]


# the SMM-less UNet (text_module none): each level's first decoder conv
# without the 16 score-map channels
SMM_LESS = [(256, 256, 128, 64), (128, 128, 256, 128), (64, 64, 512, 256), (32, 32, 512, 256)]
# plus chip_smoke.py's edge shape (8,56,56,272->128): W not a multiple of 16
SHAPES = sorted(set(_launches(256) + _launches(224) + [(56, 56, 272, 128)] + SMM_LESS
                    + [(H * 7 // 8, W * 7 // 8, C, Cout) for H, W, C, Cout in SMM_LESS]))


def test_the_launch_list_is_one_forward():
    assert sum(n for *_, n in FLAGSHIP_256) == 45
    assert (28, 28, 528, 256) in SHAPES and (112, 112, 272, 128) in SHAPES


@pytest.mark.parametrize("H,W,C,Cout", SHAPES)
def test_plan_fits_the_kernel_and_fills_the_card(H, W, C, Cout):
    plan = conv_plan(BATCH, H, W, C, Cout)
    nb = plan["nb"]
    # N covers Cout in multiples of 8, at most 256 (wgmma's N); one N block
    # up to 128 channels, 128-wide blocks past it
    assert nb in NB_CHOICES and nb % 8 == 0 and nb <= 256
    assert plan["n_blocks"] * nb >= Cout > (plan["n_blocks"] - 1) * nb
    # one N block covers Cout <= 256 unless the launch needed more blocks
    if plan["n_blocks"] > 1:
        assert Cout > 256 or BATCH * -(-H // 8) * -(-W // 8) < N_SMS
    assert plan["smem"] <= SMEM_LIMIT
    # the halo's 16-byte cp.async path only where C*2 bytes is a multiple of
    # 16; the weights' TMA bulk copies need 16-byte runs, which packing gives
    assert plan["load"] == ("cp.async" if (C * 2) % 16 == 0 else "scalar")
    assert plan["weights"] == "tma_bulk" and plan["stage_bytes"] % 16 == 0
    assert plan["stages"] >= 2
    # every launch of >= 32x32 pixels fills the 132 SMs
    if H * W >= 32 * 32:
        assert plan["blocks"] >= N_SMS, plan


@pytest.mark.parametrize("C,Cout", [(20, 5), (64, 130), (7, 3)])
def test_plan_ragged_channels(C, Cout):
    """C not a multiple of 8 takes the scalar halo path; Cout past 128 is
    covered by whole N blocks."""
    plan = conv_plan(2, 19, 23, C, Cout)
    assert plan["load"] == ("cp.async" if C % 8 == 0 else "scalar")
    assert plan["n_blocks"] * plan["nb"] >= Cout and plan["smem"] <= SMEM_LIMIT


def test_pack_weights_layout():
    """[nblock][slice][tap][nb][32], zero past C and Cout, 16-byte chunks in
    the 64-byte swizzle."""
    C, Cout, nb = 40, 11, 8
    w = torch.randn(3, 3, C, Cout)
    wp = pack_weights(w, nb)
    assert wp.shape == (2, 2, 9, nb, 32)
    for blk, s, tap, n, d, k8 in itertools.product(range(2), range(2), range(9), range(nb),
                                                   range(4), range(8)):
        c, co = s * 32 + (d ^ ((n >> 1) & 3)) * 8 + k8, blk * nb + n
        want = w[tap // 3, tap % 3, c, co] if c < C and co < Cout else 0.0
        assert float(wp[blk, s, tap, n, d * 8 + k8]) == float(want)


def test_packed_once_per_parameter():
    p = torch.nn.Parameter(torch.randn(3, 3, 16, 8))
    first = packed_weights(p, 8)
    assert packed_weights(p, 8) is first
    with torch.no_grad():
        p.mul_(2)  # an in-place update repacks
    again = packed_weights(p, 8)
    assert again is not first and torch.equal(again, 2 * first)


@pytest.mark.parametrize("H,W,C,Cout", SHAPES)
def test_fp32_plan_fits_the_kernel_and_fills_the_card(H, W, C, Cout):
    """The split-TF32 kernel: 8x16 tiles, the narrowest N block of
    NB_CHOICES_F32 that covers Cout (128-wide blocks past it), shared
    memory within the card's limit."""
    plan = conv_plan(BATCH, H, W, C, Cout, torch.float32)
    nb = plan["nb"]
    assert plan["kernel"] == "tf32x3" and (plan["th"], plan["tw"]) == (8, 16)
    assert nb == min(c for c in NB_CHOICES_F32 if c >= min(Cout, 128))
    assert plan["n_blocks"] * nb >= Cout > (plan["n_blocks"] - 1) * nb
    assert plan["smem"] == tf32_smem_bytes(nb) <= SMEM_LIMIT
    assert plan["load"] == ("cp.async" if C % 4 == 0 else "scalar")
    assert plan["stages"] == 3 and plan["stage_bytes"] == 2 * 32 * nb * 4
    tiles = BATCH * -(-H // 8) * -(-W // 16)
    assert plan["blocks"] == tiles * plan["n_blocks"]
    # every launch of >= 56x56 pixels fills the 132 SMs; at 32x32 and 28x28
    # (Cout 256) the two 128-wide N blocks leave a few idle
    if H * W >= 56 * 56:
        assert plan["blocks"] >= N_SMS, plan
    # the Cout = 5 head pays for 8 columns, not 64
    if Cout == 5:
        assert nb == 8


def test_fp32_plan_shared_memory():
    """The Python mirror of the kernel's count: the raw halo (180 pixels x 32
    channels) and scale/shift, the big and small halo tiles (rows of 36
    floats), 3 weight stages of big and small [nb][36]; two blocks fit an
    SM up to nb = 32."""
    assert tf32_smem_bytes(128) == (180 * 32 + 64 + 2 * 180 * 36 + 3 * 2 * 128 * 36) * 4
    assert tf32_smem_bytes(128) == 185728 <= SMEM_LIMIT
    assert 2 * tf32_smem_bytes(32) <= SMEM_LIMIT < 2 * tf32_smem_bytes(64)
    assert conv_plan(2, 19, 23, 7, 3, torch.float32)["load"] == "scalar"
    with pytest.raises(TypeError, match="float16"):
        conv_plan(2, 8, 8, 16, 16, torch.float16)


def test_bf16_and_fp32_copies_of_one_parameter():
    """A trained net's fp32 master weight is packed for the bf16 kernel and
    for the fp32 one in one process: two copies under two keys, both kept
    for a graph, each repacked after an in-place update."""
    p = torch.nn.Parameter(torch.randn(3, 3, 16, 8))
    bf, tf = packed_weights(p, 8, "bf16"), packed_weights(p, 8, "tf32x3")
    assert bf.dtype == torch.bfloat16 and tf.dtype == torch.float32
    assert packed_weights(p, 8, "bf16") is bf and packed_weights(p, 8, "tf32x3") is tf
    kept = packed_copies([p])
    assert len(kept) == 2 and any(k is bf for k in kept) and any(k is tf for k in kept)
    with torch.no_grad():
        p.mul_(2)
    again = packed_weights(p, 8, "tf32x3")
    assert again is not tf and torch.equal(again, 2 * tf)
    assert packed_weights(p, 8, "bf16") is not bf
