"""Spatial sharding of the PyTorch port on the CPU (``instancediff_torch/
parallel/spatial.py``): an image's height split over ranks, held against the
unsharded port and the JAX package.

In-process cases run every rank of a world as a thread of this process
(``ThreadGroup``: ``SpatialGroup``'s halo and slicing code over a shared
board instead of gloo) and hold each sharded layer, gathered, against the
layer on the whole tensor: the 3x3 conv, the stride-2 SAME conv, the k=4
transpose conv, the fused conv's plain form, both GroupNorm ops' statistics,
the score map module's memory and the bottleneck attention on gathered keys.

One spawned gloo world of four ranks runs the samplers: the drift engine of
the JAX package's ``tests/test_spatial.py`` (nf 4, ch_mult [1, 2], 16 px,
T=3, every leaf randomised) over the four against the port's unsharded call
at JAX's own tolerance (2e-5) and against JAX's single-device ``eng.test``
at ``test_torch_engine``'s sampler tolerance (1e-4); the unfused body and
the DDPM engine over two-rank groups; ``Restorer.from_config`` and
``testUM`` with ``--spatial 4``. The references are computed while the
ranks run."""

import os
import threading

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from instancediff_tpu.models.drift_model import CLIPDriftEngine as JaxEngine
from instancediff_tpu.sde import DriftSDE as JaxSDE

from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.layers import (ConvParams, conv3x3, conv_same,
                                              conv_transpose_same)
from instancediff_torch.models.scoremap import ScoreMapModule
from instancediff_torch.models.unet import SelfAttention2D
from instancediff_torch.ops.fused_gn_conv import (fused_gn_silu_conv3x3,
                                                  fused_gn_silu_conv3x3_sharded,
                                                  gn_channel_affine_plain)
from instancediff_torch.ops.group_norm_silu import (gn_affine_sharded,
                                                    group_norm_silu_plain,
                                                    group_norm_silu_sharded)
from instancediff_torch.parallel.spatial import SpatialGroup, check_height, shard_spatial
from instancediff_torch.tools import restore, testUM
from instancediff_torch.utils.convert import flax_params

import torch_dist_workers as workers
from chip_smoke import write_speckle_med
from test_torch_engine import (_jax_noise, inits_shapes_only, one_torch_thread,  # noqa: F401
                               quick_jax_compiles, randomize)

# JAX's tests/test_spatial.py engine
SETTINGS = dict(in_nc=2, out_nc=5, nf=4, ch_mult=[1, 2], context_dim=8,
                text_module="scoremap", score_map_chan=2, if_MultiScoreMap=True,
                num_res_blocks=1)
ENGINE_KW = dict(score_map_ch_mult=(1, 1), score_map_ngf=4, use_image_context=True,
                 CLIP_Type="CLIP", tiny_text_encoder=True)
T, RES = 3, 16
TOL = dict(atol=2e-5, rtol=2e-5)  # JAX's sharded-vs-single-device tolerance


class ThreadGroup(SpatialGroup):
    """Rank ``rank`` of a world whose ranks are threads of this process: the
    collectives exchange tensors through a shared board."""

    def __init__(self, rank, world, board):
        self.group, self.rank, self.world, self.staged = None, rank, world, False
        self.board = board

    def _exchange(self, t):
        slots, barrier = self.board
        slots[self.rank] = t
        barrier.wait()
        parts = list(slots)
        barrier.wait()
        return parts

    def gather_h(self, x):
        return torch.cat(self._exchange(x.contiguous()), dim=1)

    def all_reduce_sum_(self, t):
        parts = self._exchange(t.clone())
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return t.copy_(total)


def threaded(fn, world, *tensors):
    """``fn(sp, *rows)`` on every rank of a threaded world, each given its
    rows of ``tensors`` (dim 1); each rank's outputs gathered along dim 1."""
    board = ([None] * world, threading.Barrier(world, timeout=60))
    out, errors = [None] * world, []

    def run(r):
        try:
            sp = ThreadGroup(r, world, board)
            with torch.no_grad():
                out[r] = fn(sp, *(sp.rows(t) for t in tensors))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            board[1].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if isinstance(out[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*out))
    return torch.cat(out, dim=1)


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **(tol or TOL))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_convs_equal_whole(world):
    torch.manual_seed(0)
    x = _x((2, 16, 12, 6))
    conv = ConvParams(6, 5)
    torch.nn.init.normal_(conv.weight)
    torch.nn.init.normal_(conv.bias)
    same = torch.nn.Conv2d(6, 5, 3)
    down = torch.nn.Conv2d(6, 6, 3)
    up = torch.nn.ConvTranspose2d(6, 3, 4)
    with torch.no_grad():
        _close(threaded(lambda sp, r: conv3x3(r, conv, sp), world, x), conv3x3(x, conv))
        _close(threaded(lambda sp, r: conv_same(r, same, sp=sp), world, x), conv_same(x, same))
        got = threaded(lambda sp, r: conv_same(r, down, stride=2, sp=sp), world, x)
        assert got.shape == (2, 8, 6, 6)
        _close(got, conv_same(x, down, stride=2))
        got = threaded(lambda sp, r: conv_transpose_same(r, up, sp), world, x)
        assert got.shape == (2, 32, 24, 3)
        _close(got, conv_transpose_same(x, up))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fused_conv_and_group_norms_equal_whole(world):
    """The fused conv's plain form on halo-extended rows (SiLU of the
    global scale and shift on the halo rows, zero padding only at the image
    edges, the residual on the kept rows), and both GroupNorm ops with their
    statistics summed over the shards."""
    x, res = _x((2, 16, 8, 12)), _x((2, 16, 8, 10), 1)
    gamma, beta = 1 + 0.1 * _x((12,), 2), 0.1 * _x((12,), 3) + 0.5
    w, bias = 0.2 * _x((3, 3, 12, 10), 4), 0.1 * _x((2, 10), 5)
    scale, shift = gn_channel_affine_plain(x, gamma, beta, 4)
    got = threaded(lambda sp, r: gn_affine_sharded(r, gamma, beta, 4, 1e-5, sp)[0][:, None],
                   world, x)
    for rank_scale in got.unbind(1):  # every rank folds the same statistics
        _close(rank_scale, scale)
    _close(threaded(lambda sp, r, rr: fused_gn_silu_conv3x3_sharded(
        r, scale, shift, w, bias, rr, sp=sp), world, x, res),
        fused_gn_silu_conv3x3(x, scale, shift, w, bias, res))
    for silu in (True, False):
        _close(threaded(lambda sp, r: group_norm_silu_sharded(r, gamma, beta, 4, 1e-5, silu,
                                                              sp), world, x),
               group_norm_silu_plain(x, gamma, beta, 4, silu=silu))


@pytest.mark.parametrize("hw", [8, 32], ids=["whole_memory", "pooled_memory"])
def test_sharded_score_map_module_equals_whole(hw):
    torch.manual_seed(hw)
    smm = ScoreMapModule(6, 8, token_embed_dim=24, embed_dim=16)
    for p in smm.parameters():
        torch.nn.init.normal_(p, std=0.3)
    vis, text = _x((2, hw, hw, 6)), _x((5, 16), 1)
    with torch.no_grad():
        want = smm(vis, text)
    _close(threaded(lambda sp, r: smm(r, text, sp), 4, vis), want)


@pytest.mark.parametrize("plain", [False, True], ids=["flash", "plain"])
def test_sharded_attention_on_gathered_keys_equals_whole(plain):
    """Local queries (N = HW / world) against every rank's keys and values
    (N = HW), the GroupNorm's statistics summed over the ranks."""
    torch.manual_seed(1)
    att = SelfAttention2D(16)
    for p in att.parameters():
        torch.nn.init.normal_(p, std=0.3)
    h = _x((2, 8, 8, 16)) + 0.5
    with torch.no_grad():
        want = att(h, plain)
    _close(threaded(lambda sp, r: att(r, plain, sp), 4, h), want)


def test_height_rule_refuses_what_does_not_split():
    check_height(64, 64, 4, 4, (0, 1, 2, 3))  # 64 / (4 x 2^3) rows, 16 / 4 per window
    with pytest.raises(ValueError, match=r"divide by world x 2\^\(levels-1\) = 32"):
        check_height(48, 48, 4, 4)
    with pytest.raises(ValueError, match="pooling window"):
        check_height(36, 36, 4, 1, (0,))  # 2-row windows over shards of 9 rows
    check_height(36, 36, 2, 1, (0,))
    with pytest.raises(ValueError, match="split over 4 ranks"):
        SpatialGroup.rows(type("G", (), {"world": 4, "rank": 0})(), torch.zeros(1, 6, 2, 1))
    sp = type("G", (), {"world": 3, "rank": 1, "rows": SpatialGroup.rows})()
    batch = shard_spatial({"input": np.arange(12).reshape(1, 6, 2, 1), "type_idx": [3]}, sp)
    assert batch["input"].ravel().tolist() == [4, 5, 6, 7] and batch["type_idx"] == [3]


def jax_engine(state, text):
    """JAX's tests/test_spatial.py engine holding the trees ``state`` and
    ``text``."""
    with inits_shapes_only("CLIPDriftEngine"):  # every leaf is set below
        eng = JaxEngine(dnet_settings=SETTINGS, nnet_settings=SETTINGS,
                        sde=JaxSDE(T=T, max_sigma=0.4), image_size=RES, if_train=False,
                        seed=0, **ENGINE_KW)
    eng.state.update(state)
    eng.text_params = text
    return eng


def test_four_ranks_sample_as_one_process_and_as_jax(tmp_path):
    """One gloo world of four ranks (started first; the references are
    computed here while it runs):
    - the drift sampler with the images' height split over the four (4
      rows each at level 0, 2 at the bottleneck) against the port's
      unsharded call and JAX's single-device ``eng.test`` on JAX's noise;
    - over two ranks (groups {0, 1} and {2, 3}), with the noise drawn on
      every rank from one seeded generator: the drift sampler on the
      unfused body (the GroupNorm's sharded form) and the DDPM sampler,
      each against the port's unsharded call;
    - ``Restorer.from_config(spatial=4)`` against ``spatial=0``, and
      ``testUM --spatial 4`` against ``testUM`` and ``tools/restore
      --spatial 4`` against ``tools/restore`` (rank 0 alone writes)."""
    mu = np.asarray(jnp.clip(jax.random.normal(jax.random.key(0), (2, RES, RES, 1)), -1, 1))
    batch = {"input": mu, "type_idx": np.array([0, 3]), "A_emb": np.zeros((2, 1, 8),
                                                                          np.float32)}
    eps, zs = _jax_noise(jax.random.key(3), mu.shape, T)
    # every leaf randomised (the flax trees of the port's engine, which JAX's takes too)
    rng = np.random.default_rng(0)
    eng = workers.spatial_engine(SETTINGS, ENGINE_KW, None, None)
    state = {k: randomize(flax_params(eng.nets[k]), rng) for k in ("drift", "noise", "d_ema",
                                                                  "n_ema")}
    text = randomize(flax_params(eng.text_encoder), rng)
    args = (SETTINGS, ENGINE_KW, state, text)
    cases = {"jax_noise": (args, batch, {"init_noise": eps, "step_noise": zs})}

    rng = np.random.default_rng(2)
    batch2 = {"input": rng.uniform(-1, 1, (2, RES, RES, 1)).astype(np.float32),
              "type_idx": np.array([1, 4]), "A_emb": rng.standard_normal((2, 1, 8)).astype(
                  np.float32)}
    unfused = (SETTINGS, dict(ENGINE_KW, engine_opts={"fused_gnconv": False}), state, text)
    ddpm_settings = dict(SETTINGS, if_MultiScoreMap=False, score_map_ngf=4)
    ddpm_kw = dict(use_image_context=True, tiny_text_encoder=True)
    net = CLIPDDPMEngine(ddpm_settings, device="cpu", **ddpm_kw).nets["noise"]
    ddpm_state = {k: randomize(flax_params(net), rng) for k in ("noise", "n_ema")}
    pair_cases = {"unfused": (unfused, batch2, {"seed": 1, "eta": 1.0}),
                  "ddpm": ((ddpm_settings, ddpm_kw, ddpm_state, text, "ddpm"), batch2,
                           {"seed": 2})}

    opt = yaml.safe_load(open("Configurations/tiny_cpu.yml"))
    names = ["speckle in OCT", "Gaussian noise in MRI"]
    index = write_speckle_med(str(tmp_path / "data"), 2, 32, 16, names)
    opt["datasets"] = {"test": {"name": "test", "mode": "SpeckleMed", "batch_size": 2,
                                "resolution": 32, "emb_dim": 16, "dataset_file": index,
                                "use_artifact_type": names}}
    opt["test"].update(pth_dir=None, batch_size=2, result_dir=str(tmp_path / "results"))
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(yaml.safe_dump(opt))
    images = rng.uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    argv = ["-opt", str(cfg), "--device", "cpu", "--sample-steps", "2"]
    files = []
    for i, im in enumerate(images):
        files.append(str(tmp_path / f"scan{i}.npy"))
        np.save(files[-1], im[..., 0])
    restore_argv = argv + ["--images", *files, "--type", *names, names[0], "--pre-normalized",
                           "--batch", "2"]
    started = workers.start_world(workers.spatial_rank, 4, cases, pair_cases,
                                  (str(cfg), images, names + names[:1], argv,
                                   restore_argv + ["--out", str(tmp_path / "restored")]))

    want_jax = np.asarray(jax_engine(state, text).test(
        {k: jnp.asarray(v) for k, v in batch.items()}, key=jax.random.key(3)))
    eng = workers.spatial_engine(*args)
    want = {"jax_noise": eng.test(batch, init_noise=torch.tensor(eps),
                                  step_noise=[torch.tensor(z) for z in zs]).numpy()}
    for name, (a, b, kw) in pair_cases.items():
        want[name] = workers.spatial_engine(*a).test(
            b, torch.Generator().manual_seed(kw["seed"]),
            **{k: v for k, v in kw.items() if k != "seed"}).numpy()
    with pytest.raises(ValueError, match="does not split"):
        eng.test(dict(batch, input=mu[:, :12]), spatial=type(
            "G", (), {"world": 4, "rank": 0})())
    opt["test"]["result_dir"] = str(tmp_path / "results_whole")
    whole = tmp_path / "tiny_whole.yml"
    whole.write_text(yaml.safe_dump(opt))
    torch.manual_seed(0)
    testum = testUM.main(["-opt", str(whole)] + argv[2:])
    torch.manual_seed(0)
    restored = restore.main(restore_argv + ["--out", str(tmp_path / "restored_whole")])
    ranks = workers.finish_world(started)

    for r in ranks:  # every rank holds the whole images
        for name in want:
            assert r[name + "_world"] == (4 if name in cases else 2)
            np.testing.assert_allclose(r[name], want[name], **TOL)
        np.testing.assert_allclose(r["jax_noise"], want_jax, rtol=0, atol=1e-4)
        assert r["served_world"] == 4 and r["served"].shape == images.shape
        np.testing.assert_allclose(r["served"], ranks[0]["served_whole"], **TOL)
    assert ranks[0]["served_whole_world"] == 1
    assert len(os.listdir(tmp_path / "results" / names[0])) == 2
    # testUM --spatial 4: every rank scores what one process scores
    for r in ranks:
        assert sorted(r["testum"]) == sorted(testum)
        for name, v in testum.items():
            assert r["testum"][name]["num"] == v["num"] == 2
            for k in ("RMSE", "SSIM", "PSNR"):
                np.testing.assert_allclose(r["testum"][name][k], v[k], rtol=1e-4)
    # tools/restore --spatial 4: rank 0 writes what one process writes
    assert [r["restore"] == [] for r in ranks] == [False, True, True, True]
    assert [os.path.basename(p) for p in ranks[0]["restore"]] == \
        [os.path.basename(p) for p in restored] == [f"scan{i}_restored.raw" for i in range(3)]
    for got, want in zip(ranks[0]["restore"], restored):
        np.testing.assert_allclose(np.fromfile(got, np.float32), np.fromfile(want, np.float32),
                                   **TOL)
