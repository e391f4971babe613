"""The GroupNorm kernels' launch plan, on the CPU.

``gn_plan`` chooses the vector width, the path (one cluster launch, or the
statistics and apply launches), the rows per block and the shared memory of
``csrc/group_norm_silu.cu`` in plain Python; these tests hold it to the
kernels' limits at every GroupNorm and statistics launch of the three
flagship paths (batch 8, 256 px): ``group_norm_silu`` on the unfused drift
body and the DDPM net, ``gn_channel_affine`` on the fused drift body.
Nothing here imports CUDA code or JAX.
"""

import pytest

from instancediff_torch.ops.group_norm_silu import (
    CLUSTER,
    CLUSTER_MAX_BYTES,
    N_SMS,
    SMEM_LIMIT,
    cluster_smem_bytes,
    gn_plan,
)

# (H, W, C, G, launches) of one flagship drift UNet forward at 256 px: 22
# ResBlocks x 2 GroupNorms and the output head (45), the decoder concats
# [h | skip | score map] giving C = 144, 272 and 528
DRIFT_256 = [
    (256, 256, 64, 32, 10), (256, 256, 144, 24, 1), (128, 128, 64, 32, 1),
    (128, 128, 128, 32, 8), (128, 128, 272, 17, 1), (64, 64, 128, 32, 1),
    (64, 64, 256, 32, 8), (64, 64, 528, 24, 1), (32, 32, 256, 32, 13), (32, 32, 528, 24, 1)]
# the DDPM net: one score map (level 0), so the deeper concats are [h | skip]
DDPM_256 = [s for s in DRIFT_256 if s[2] not in (272, 528)] + [
    (128, 128, 256, 32, 1), (64, 64, 512, 32, 1), (32, 32, 512, 32, 1)]
# the SMM-less UNet (text_module none): every decoder concat is [h | skip]
SMM_LESS_256 = [s for s in DDPM_256 if s[2] != 144] + [(256, 256, 128, 32, 1)]
BATCH = 8
SHAPES = sorted({s[:4] for s in DRIFT_256 + DDPM_256 + SMM_LESS_256})


def test_the_launch_lists_are_one_forward():
    assert sum(s[-1] for s in DRIFT_256) == 45
    assert sum(s[-1] for s in DDPM_256) == 45
    assert sum(s[-1] for s in SMM_LESS_256) == 45


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("H,W,C,G", SHAPES)
def test_plan_fits_the_kernels_and_fills_the_card(H, W, C, G, itemsize):
    HW = H * W
    plan = gn_plan(BATCH, HW, C, G, itemsize)
    # the statistics launch (every gn_channel_affine, and group_norm_silu's
    # two-launch path) and the apply launch on its grid give every SM at
    # least two blocks
    assert plan["blocks"] >= 2 * N_SMS, plan
    chunks = plan["blocks"] // BATCH
    assert (chunks - 1) * plan["rows"] < HW <= chunks * plan["rows"]
    assert plan["scratch"] == 2 * BATCH * chunks * G + 2 * BATCH * G
    assert plan["smem"] <= SMEM_LIMIT and plan["cluster_smem"] <= SMEM_LIMIT
    image = HW * C * itemsize
    if plan["path"] == "cluster":
        # an image fits in the cluster's shared memory; one block per SM on 8
        # SMs per image (64 SMs: the single read beat the two launches there)
        assert plan["cluster"] == CLUSTER and image <= CLUSTER_MAX_BYTES
        assert image <= plan["cluster"] * plan["cluster_smem"]
        assert plan["cluster_smem"] == cluster_smem_bytes(
            -(-HW // plan["cluster"]), C, G, plan["vec"], itemsize)
        assert plan["cluster_blocks"] == BATCH * plan["cluster"] >= 64
    else:
        assert plan["cluster"] == 0 and plan["cluster_smem"] == 0
        assert image > CLUSTER_MAX_BYTES or image > CLUSTER * SMEM_LIMIT
    assert plan["vec"] == 16 // itemsize  # every flagship C is a multiple of 8


def test_the_flagship_levels_take_the_expected_path():
    """bf16: the cluster path exactly where an image of at most
    CLUSTER_MAX_BYTES fits a cluster (the 32^2 levels up to 512 channels and
    64^2 at 128, where it beat the two launches on the card); 256^2, 128^2
    and the ragged 528-channel concats take the two launches."""
    paths = {(H, C): gn_plan(BATCH, H * W, C, G)["path"] for H, W, C, G in SHAPES}
    for H, W, C, G in SHAPES:
        fits = cluster_smem_bytes(-(-H * W // CLUSTER), C, G, 8, 2) <= SMEM_LIMIT
        want = fits and H * W * C * 2 <= CLUSTER_MAX_BYTES
        assert paths[(H, C)] == ("cluster" if want else "two_launch"), (H, C)
    assert {hc for hc, p in paths.items() if p == "cluster"} == {(32, 256), (32, 512), (64, 128)}


@pytest.mark.parametrize("C,G,itemsize,vec", [(20, 5, 2, 1), (20, 5, 4, 4), (18, 6, 4, 1),
                                              (36, 18, 2, 1), (36, 18, 4, 4), (24, 24, 2, 8),
                                              (6, 3, 4, 1)])
def test_vector_width_falls_to_one_element(C, G, itemsize, vec):
    """16-byte loads only where C is a multiple of 16 bytes' worth."""
    plan = gn_plan(3, 19 * 23, C, G, itemsize)
    assert plan["vec"] == vec
    assert plan["smem"] <= SMEM_LIMIT and plan["blocks"] >= 3


def test_forced_paths():
    """cluster=0 forces the two launches; a cluster that cannot hold the
    image, or of another size than CLUSTER, is refused."""
    assert gn_plan(BATCH, 32 * 32, 256, 32, 2, cluster=0)["path"] == "two_launch"
    assert gn_plan(BATCH, 32 * 32, 256, 32, 2, cluster=8)["cluster"] == 8
    with pytest.raises(ValueError, match="cluster"):
        gn_plan(BATCH, 256 * 256, 64, 32, 2, cluster=8)
    with pytest.raises(ValueError, match="cluster"):
        gn_plan(BATCH, 32 * 32, 256, 32, 2, cluster=16)
