"""Parity of the port's image tower (``instancediff_torch/models/clip_vit.py``,
``pos_embed.py``) with the JAX package's on the CPU, and of the on-device
image context through ``Restorer.from_config``: the tower in both flavours
(timm / BiomedCLIP and OpenAI), the position tables, the torch-checkpoint
loader, a BiomedCLIP drift engine at ``tiny_cpu.yml``'s widths sampling with
the tower attached (and without it), and ``testUM`` with
``test.on_device_emb``.

Every parameter leaf is drawn from a numpy seed; the JAX engine is built
once, its inits traced for shapes only."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

import instancediff_tpu.models as jax_models
from instancediff_tpu.models import clip_vit as jax_vit
from instancediff_tpu.models import pos_embed as jax_pos
from instancediff_tpu.sde import create_sde as jax_create_sde
from instancediff_tpu.serving import Restorer as JaxRestorer
from instancediff_tpu.utils import checkpoint as jax_ckpt

import chip_smoke
from instancediff_torch.models import clip_vit, pos_embed
from instancediff_torch.models.engine import TEXT_SIDECAR
from instancediff_torch.models.layers import cast_compute_
from instancediff_torch.serving import IMAGE_SIDECAR, Restorer
from instancediff_torch.tools import testUM
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_biomedclip import init_shapes, inits_shapes_only
from test_torch_engine import (_jax_noise, one_torch_thread, quick_jax_compiles,  # noqa: F401
                               randomize)
from test_torch_eval import _dataset_opt, _jax_options

CONFIG = "Configurations/tiny_cpu.yml"
ITER, RES, EMB, STEPS = 4, 32, 16, 2
NETS = ("drift", "noise", "d_ema", "n_ema")
TINY = dict(image_size=32, patch_size=8, width=32, layers=2, heads=4, embed_dim=16)
# the JAX tower's fields of each of the port's flavours
JAX_FLAVOURS = {"timm": dict(act="gelu", ln_eps=1e-6, use_ln_pre=False),
                "openai": dict(act="quick_gelu", ln_eps=1e-5, use_ln_pre=True)}
# bf16: both sides round every matmul input and the output to bf16
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _images(seed, n=2, res=RES):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 1)).astype(np.float32)


def _jax_tower(seed=1, flavour="timm", dtype=jnp.float32, **kw):
    """The JAX tower of ``flavour`` and ``kw`` and its parameters, every
    leaf from ``seed``."""
    tower = jax_vit.CLIPVisionTower(**kw, **JAX_FLAVOURS[flavour], dtype=dtype)
    params = init_shapes(tower, jnp.zeros((1, kw["image_size"], kw["image_size"], 1)))
    return tower, randomize(params, np.random.default_rng(seed))


def _port_tower(params, dtype=torch.float32, **kw):
    """The port's tower of ``kw`` (``flavour`` included) filled from
    ``params``."""
    tower = load_flax_params(clip_vit.CLIPVisionTower(**kw), params)
    if dtype != torch.float32:
        cast_compute_(tower, dtype, master=True)
    return tower


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ---------------------------------------------------------------- the tower


@pytest.mark.parametrize("flavour,pos_type,ls_init,dtype", [
    ("timm", "learnable", None, "float32"), ("timm", "sin_cos_2d", 0.1, "float32"),
    ("openai", "learnable", 0.1, "float32"), ("openai", "sin_cos_2d", None, "float32"),
    ("timm", "learnable", None, "bfloat16"), ("timm", "sin_cos_2d", 0.1, "bfloat16")])
def test_tower_matches_jax(flavour, pos_type, ls_init, dtype):
    """Both flavours, both position tables, with and without LayerScale;
    fp32 within 1e-5, bf16 (fp32 norms; the timm flavour, which the engines
    and BiomedCLIP build) within 1e-2 of the largest output."""
    kw = dict(TINY, pos_embed_type=pos_type, ls_init=ls_init)
    tower, params = _jax_tower(flavour=flavour, dtype=getattr(jnp, dtype), **kw)
    x = _images(2)
    want = tower.apply(params, x)
    got = _port_tower(params, getattr(torch, dtype), flavour=flavour, **kw)
    assert [k for k in got.state_dict() if "ls_" in k] == (
        [] if ls_init is None else ["block_0.ls_1", "block_0.ls_2", "block_1.ls_1",
                                    "block_1.ls_2"])
    with torch.no_grad():
        _close(got(torch.from_numpy(x)).float(), want, TOL[dtype])


def test_sin_cos_table_starts_at_jax_init():
    kw = dict(TINY, pos_embed_type="sin_cos_2d")
    params = jax.jit(jax_vit.CLIPVisionTower(**kw).init)(jax.random.key(0),
                                                        jnp.zeros((1, 32, 32, 1)))
    np.testing.assert_array_equal(clip_vit.CLIPVisionTower(**kw).pos_embed.detach().numpy(),
                                  np.asarray(params["params"]["pos_embed"]))


def test_image_context_and_encode_image_fn_match_jax():
    tower, params = _jax_tower(**TINY)
    x = _images(3)
    port = _port_tower(params, **TINY)
    with torch.no_grad():
        got = clip_vit.encode_image_fn(port)(torch.from_numpy(x))
        raw = clip_vit.encode_image_fn(port, normalize=False)(torch.from_numpy(x))
    _close(got, jax_vit.encode_image_fn(tower, params)(x), 1e-5)
    _close(raw, jax_vit.encode_image_fn(tower, params, normalize=False)(x), 1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("grid,cls", [(4, False), (14, True)])
def test_sincos_pos_embed_matches_jax(grid, cls):
    _close(pos_embed.get_2d_sincos_pos_embed(32, grid, cls),
           jax_pos.get_2d_sincos_pos_embed(32, grid, cls), 1e-6)


@pytest.mark.parametrize("g_old,g_new", [(14, 16), (16, 14), (4, 7), (7, 4), (4, 4)])
def test_interpolate_pos_embed_matches_jax(g_old, g_new):
    """JAX's antialiased cubic resize of the grid rows, the class row kept:
    within 1e-6 of the table's largest value (JAX sums in float32)."""
    pos = np.random.default_rng(g_old).standard_normal((1 + g_old ** 2, 24)).astype(np.float32)
    got = pos_embed.interpolate_pos_embed(pos, 1 + g_new ** 2)
    np.testing.assert_array_equal(got[0].numpy(), pos[0])
    _close(got, jax_pos.interpolate_pos_embed(pos, 1 + g_new ** 2), 1e-6)
    with pytest.raises(ValueError, match="non-square"):
        pos_embed.interpolate_pos_embed(pos, 1 + g_new ** 2 + 1)


def _state_dict(kind, rng, width=32, embed=16, grid=4, P=8):
    """A synthetic ViT state dict: open_clip / timm trunk names (as deep as
    the tiny tower: JAX's loader takes no deeper trunk) or OpenAI names (one
    block deeper), LayerScale gammas in both."""
    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.2)

    n = grid * grid + 1
    layers = 2 if kind == "openclip" else 3
    if kind == "openclip":
        sd = {"visual.trunk.patch_embed.proj.weight": r(width, 3, P, P),
              "visual.trunk.patch_embed.proj.bias": r(width), "visual.trunk.cls_token": r(1, 1, width),
              "visual.trunk.pos_embed": r(1, n, width), "visual.trunk.norm.weight": 1 + r(width),
              "visual.trunk.norm.bias": r(width), "visual.head.proj.weight": r(embed, width)}
        for i in range(layers):
            T = f"visual.trunk.blocks.{i}"
            sd.update({f"{T}.norm1.weight": 1 + r(width), f"{T}.norm1.bias": r(width),
                       f"{T}.norm2.weight": 1 + r(width), f"{T}.norm2.bias": r(width),
                       f"{T}.attn.qkv.weight": r(3 * width, width), f"{T}.attn.qkv.bias": r(3 * width),
                       f"{T}.attn.proj.weight": r(width, width), f"{T}.attn.proj.bias": r(width),
                       f"{T}.mlp.fc1.weight": r(4 * width, width), f"{T}.mlp.fc1.bias": r(4 * width),
                       f"{T}.mlp.fc2.weight": r(width, 4 * width), f"{T}.mlp.fc2.bias": r(width),
                       f"{T}.ls1.gamma": r(width), f"{T}.ls2.gamma": r(width)})
        return sd
    sd = {"visual.conv1.weight": r(width, 3, P, P), "visual.class_embedding": r(width),
          "visual.positional_embedding": r(n, width), "visual.proj": r(width, embed),
          "visual.ln_pre.weight": 1 + r(width), "visual.ln_pre.bias": r(width),
          "visual.ln_post.weight": 1 + r(width), "visual.ln_post.bias": r(width)}
    for i in range(layers):
        R = f"visual.transformer.resblocks.{i}"
        sd.update({f"{R}.ln_1.weight": 1 + r(width), f"{R}.ln_1.bias": r(width),
                   f"{R}.ln_2.weight": 1 + r(width), f"{R}.ln_2.bias": r(width),
                   f"{R}.attn.in_proj_weight": r(3 * width, width),
                   f"{R}.attn.in_proj_bias": r(3 * width),
                   f"{R}.attn.out_proj.weight": r(width, width), f"{R}.attn.out_proj.bias": r(width),
                   f"{R}.mlp.c_fc.weight": r(4 * width, width), f"{R}.mlp.c_fc.bias": r(4 * width),
                   f"{R}.mlp.c_proj.weight": r(width, 4 * width), f"{R}.mlp.c_proj.bias": r(width),
                   f"{R}.ls_1.gamma": r(width), f"{R}.ls_2.gamma": r(width)})
    return sd


@pytest.mark.parametrize("kind,image_size", [("openclip", 32), ("openai", 32), ("openai", 48)])
def test_vision_loader_matches_jax(kind, image_size, tmp_path):
    """``load_torch_clip_vision_weights`` on a synthetic open_clip or OpenAI
    state dict (from a file), at the checkpoint's grid and at another (the
    position table resampled): the same parameters as JAX's loader (within
    1e-6) and the same tower outputs (1e-5)."""
    kw = dict(TINY, image_size=image_size, ls_init=0.1,
              flavour="timm" if kind == "openclip" else "openai")
    tower, params = _jax_tower(**kw)
    sd = _state_dict(kind, np.random.default_rng(3))
    path = str(tmp_path / "ckpt.pt")
    torch.save(sd, path)
    want = jax_vit.load_torch_clip_vision_weights(params, path)
    port = clip_vit.load_torch_clip_vision_weights(_port_tower(params, **kw), path)
    got = flax_params(port)["params"]
    for key, value in jax.tree_util.tree_leaves_with_path(want["params"]):
        sub = got
        for k in key:
            sub = sub[k.key]
        _close(sub, value, 1e-6)
    x = _images(4, res=image_size)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), tower.apply(want, x), 1e-5)
    if kind == "openai":
        assert not port.patch_embed.bias.any()
    with pytest.raises(FileNotFoundError):
        clip_vit.load_torch_clip_vision_weights(port, str(tmp_path / "missing.pt"))


def test_training_only_options_raise(monkeypatch):
    """The training-only options now run (they raised when the tower was
    frozen only): ``patch_dropout=0.5`` in train mode equals JAX's tower on
    JAX's own PatchDropout draw (recorded from its key), in both flavours,
    and is inert in eval mode; a ``drop_path_rate`` tower in eval mode
    equals JAX's. What still raises: an unknown flavour, a PatchDropout
    share outside [0, 1), and a train-mode call without ``rng``."""
    draws = []
    real = jax_vit.patch_dropout_tokens

    def record(key, x, prob, exclude_first_token=True):
        draws.append(np.asarray(jax.random.normal(key, (x.shape[0], x.shape[1] - 1))))
        return real(key, x, prob, exclude_first_token)

    monkeypatch.setattr(jax_vit, "patch_dropout_tokens", record)
    x = _images(6)
    for flavour in ("timm", "openai"):
        tower, params = _jax_tower(seed=5, flavour=flavour, patch_dropout=0.5, **TINY)
        want = tower.apply(params, x, deterministic=False,
                           rngs={"patch_dropout": jax.random.key(2)})
        port = _port_tower(params, flavour=flavour, patch_dropout=0.5, **TINY)
        with torch.no_grad():
            _close(port(torch.from_numpy(x), deterministic=False, rng=iter(draws[-1:])), want,
                   1e-5)
            _close(port(torch.from_numpy(x)), tower.apply(params, x), 1e-5)
            dp = _port_tower(params, flavour=flavour, drop_path_rate=0.1, **TINY)
            _close(dp(torch.from_numpy(x)), tower.apply(params, x), 1e-5)
            with pytest.raises(ValueError, match="needs rng"):
                port(torch.from_numpy(x), deterministic=False)
    with pytest.raises(ValueError, match="unknown flavour"):
        clip_vit.CLIPVisionTower(**TINY, flavour="eva")
    with pytest.raises(ValueError, match="patch_dropout"):
        clip_vit.CLIPVisionTower(**TINY, patch_dropout=1.0)
    assert clip_vit.CLIPVisionTower(**TINY)(torch.zeros(1, 32, 32, 1)).shape == (1, 16)


# ---------------------------------------------------------------- the engine


def _config(tmp_path, **test_opt):
    """tiny_cpu.yml with the BiomedCLIP text tower and ``test`` updated."""
    opt = yaml.safe_load(open(CONFIG))
    opt["models"]["DriftNoise"]["CLIP_Type"] = "BiomedCLIP"
    opt["test"].update(test_opt)
    path = tmp_path / "biomedclip.yml"
    path.write_text(yaml.safe_dump(opt))
    return str(path)


@pytest.fixture(scope="module")
def jax_engine():
    """A tiny JAX drift engine with the BiomedCLIP text tower, every leaf
    randomised."""
    opt = _jax_options(CONFIG)
    model_opt = dict(opt["models"]["DriftNoise"], CLIP_Type="BiomedCLIP")
    with inits_shapes_only("CLIPDriftEngine"):
        eng = jax_models.create_model(None, model_opt, phase="test", image_size=RES)
    eng.set_sde(jax_create_sde(opt["sdes"]["driftSDE"]))
    rng = np.random.default_rng(0)
    for key in NETS:
        eng.state[key] = chip_smoke.seeded_tree(eng.state[key], rng)
    eng.text_params = chip_smoke.seeded_tree(eng.text_params, rng)
    return eng


@pytest.fixture(scope="module")
def bundle(jax_engine, tmp_path_factory):
    """JAX's bundle, text sidecar and (``tools/export_image_params.py``) image
    sidecar."""
    from tools import export_image_params

    d = str(tmp_path_factory.mktemp("models"))
    jax_engine.save(d, ITER)
    jax_ckpt.save_pytree(jax_engine.text_params, os.path.join(d, TEXT_SIDECAR))
    cfg = _config(tmp_path_factory.mktemp("cfg"))
    assert export_image_params.main(["-opt", cfg, "--models-dir", d]) == \
        os.path.join(d, IMAGE_SIDECAR)
    return d


def _request(jax_engine):
    rng = np.random.default_rng(9)
    return {"input": _images(10), "type_idx": np.array([0, 4], np.int32),
            "A_emb": rng.standard_normal((2, 1, EMB)).astype(np.float32)}


def _sample_both(jax_engine, port_engine, batch, key=jax.random.key(5)):
    want = np.asarray(jax_engine.test(batch, key, sample_steps=STEPS))
    eps, zs = _jax_noise(key, batch["input"].shape, STEPS)
    got = port_engine.test(batch, sample_steps=STEPS, init_noise=torch.tensor(eps),
                           step_noise=[torch.tensor(z) for z in zs])
    return got.numpy(), want


def test_biomedclip_drift_sampler_matches_jax(jax_engine, bundle, tmp_path):
    """``CLIP_Type: BiomedCLIP`` (the PubMedBERT tower, WordPiece ids and
    mask, 48-wide SMM contexts) served from JAX's bundle through
    ``from_config``, the image context from ``A_emb``: within 1e-4 of JAX
    on JAX's noise."""
    r = Restorer.from_config(_config(tmp_path), pth_dir=bundle, iteration=ITER, device="cpu")
    eng = r.engine
    assert eng.image_tower is None and eng.prompt_mask is not None
    np.testing.assert_array_equal(eng.prompt_ids.numpy(), np.asarray(jax_engine.prompt_ids))
    np.testing.assert_array_equal(eng.prompt_mask.numpy(), np.asarray(jax_engine.prompt_mask))
    got, want = _sample_both(jax_engine, eng, _request(jax_engine))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture
def jax_restorer_with_tower(jax_engine, bundle, tmp_path, monkeypatch):
    """JAX's ``Restorer.from_config`` with ``test.on_device_emb`` on the
    fixture's engine (its ``create_model`` patched to return it): the bundle
    loaded, the tower drawn from key 7 and attached; detached afterwards."""
    monkeypatch.setattr(jax_models, "create_model", lambda *a, **k: jax_engine)
    cfg = _config(tmp_path, on_device_emb=True)
    r = JaxRestorer.from_config(cfg, pth_dir=bundle, iteration=ITER)
    assert r.engine is jax_engine and jax_engine.image_tower is not None
    yield r, cfg
    jax_engine.image_tower = jax_engine.image_tower_params = jax_engine._sample_fn = None


def test_tower_from_config_matches_jax(jax_restorer_with_tower, bundle, tmp_path):
    """``from_config`` with ``test.on_device_emb``: the port reads the tower
    ``tools/export_image_params.py`` wrote (JAX's key-7 draw) and embeds the
    input itself; ``A_emb`` is not read. Within 1e-4 of JAX on JAX's noise;
    without the sidecar it raises."""
    jax_r, cfg = jax_restorer_with_tower
    r = Restorer.from_config(cfg, pth_dir=bundle, iteration=ITER, device="cpu")
    eng = r.engine
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_r.engine.image_tower_params):
        sub = flax_params(eng.image_tower)
        for k in path:
            sub = sub[k.key]
        np.testing.assert_array_equal(sub, np.asarray(leaf))
    batch = _request(jax_r.engine)
    got, want = _sample_both(jax_r.engine, eng, batch)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the image context is the tower's: another A_emb changes nothing
    again, _ = _sample_both(jax_r.engine, eng, dict(batch, A_emb=-batch["A_emb"]))
    np.testing.assert_array_equal(again, got)
    empty = tmp_path / "no_sidecar"
    empty.mkdir()
    for name in os.listdir(bundle):
        if name != IMAGE_SIDECAR:
            os.symlink(os.path.join(bundle, name), empty / name)
    with pytest.raises(FileNotFoundError, match="export_image_params.py"):
        Restorer.from_config(cfg, pth_dir=str(empty), iteration=ITER, device="cpu")


def test_testUM_with_on_device_emb(bundle, tmp_path, monkeypatch):
    """The port's ``testUM`` with ``test.on_device_emb``: one batch of two,
    the attached tower embedding it once, finite metrics."""
    import instancediff_torch.models.engine as engine_mod

    calls = []

    def counted(tower, images):
        calls.append(tuple(images.shape))
        return clip_vit.image_context(tower, images)

    monkeypatch.setattr(engine_mod, "image_context", counted)
    names = ("speckle in OCT", "Gaussian noise in MRI")
    index = chip_smoke.write_speckle_med(str(tmp_path / "data"), 1, RES, EMB, names)
    opt = yaml.safe_load(open(_config(tmp_path, on_device_emb=True)))
    opt["datasets"] = {"test": dict(_dataset_opt(index, 1), use_artifact_type=list(names))}
    opt["test"].update(pth_dir=bundle, iter=ITER, batch_size=2,
                       result_dir=str(tmp_path / "results"))
    cfg = tmp_path / "test.yml"
    cfg.write_text(yaml.safe_dump(opt))
    results = testUM.main(["-opt", str(cfg), "--device", "cpu", "--sample-steps", str(STEPS)])
    assert sorted(results) == sorted(names) and calls == [(2, RES, RES, 1)]
    for name in names:
        assert results[name]["num"] == 1 and np.isfinite(results[name]["PSNR"]).all()
