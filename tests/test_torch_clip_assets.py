"""Parity of the port's CLIP checkpoint assets with the JAX package's on the
CPU: the image transforms (byte for byte under the same numpy generator),
the pretrained registry and its local-only resolution, ``load_openai_model``
(ViT and RN checkpoints, a state dict and a TorchScript archive), the
big_vision loader, and the HF text-tower registry with its towers
(roberta's position offset of 2 included).

Tolerance: float32 embeddings within 1e-5 of the largest |value|; loaded
parameters bit for bit (a resampled position grid within 1e-6 of its
largest value, ``test_torch_vision_towers.assert_trees_equal``)."""

import contextlib
import dataclasses
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.data import transforms as jax_tf
from instancediff_tpu.models import big_vision as jax_bv
from instancediff_tpu.models import clip_vit as jax_vit
from instancediff_tpu.models import hf_configs as jax_hf
from instancediff_tpu.models import openai as jax_openai
from instancediff_tpu.models import pretrained as jax_pre

from chip_smoke import save_torchscript
from instancediff_torch.data import transforms as tf
from instancediff_torch.models import big_vision, clip_vit, hf_configs, openai, pretrained
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import quick_jax_compiles  # noqa: F401
from test_torch_vision_towers import (_close, _t, assert_trees_equal, init, one_torch_thread,  # noqa: F401
                                      rn_state_dict)


def _image(h=40, w=50, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("mode,size", [("shortest", 224), ("shortest", (32, 48)),
                                       ("longest", (32, 48)), ("squash", 24)])
def test_eval_transform_matches_jax(mode, size):
    """Eval transforms (resize mode, centre crop or pad, normalise) on a
    uint8 RGB image and a float grey one: the same bytes as JAX's."""
    for img in (_image(), np.random.default_rng(1).random((37, 29)).astype(np.float32)):
        for interpolation in ("bicubic", "bilinear"):
            kw = dict(resize_mode=mode, interpolation=interpolation, fill_color=7)
            got = tf.image_transform(size, is_train=False, **kw)(img)
            want = jax_tf.image_transform(size, is_train=False, **kw)(img)
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("aug", [None, dict(color_jitter=0.4, color_jitter_prob=1.0),
                                 dict(color_jitter=(0.3, 0.2, 0.1, 0.05), color_jitter_prob=1.0,
                                      gray_scale_prob=0.5, scale=(0.5, 1.0), ratio=(0.8, 1.2))],
                         ids=["default", "jitter", "jitter_hue_gray"])
def test_train_transform_matches_jax(aug):
    """Train transforms (RandomResizedCrop, colour jitter, grayscale) under
    one numpy generator seed: the same bytes as JAX's, draw for draw."""
    got_fn = tf.image_transform(32, is_train=True, aug_cfg=aug)
    want_fn = jax_tf.image_transform(32, is_train=True, aug_cfg=aug)
    g_rng, w_rng = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(4):
        got, want = got_fn(_image(seed=i), rng=g_rng), want_fn(_image(seed=i), rng=w_rng)
        assert got.tobytes() == want.tobytes()
    with pytest.raises(NotImplementedError):
        tf.image_transform(32, is_train=True, aug_cfg=dict(use_timm=True))


def test_preprocess_cfg_and_merge_match_jax():
    """``PreprocessCfg`` / ``AugmentationCfg`` defaults, ``input_size``, the
    merge helpers (unknown and None keys dropped) and ``image_transform_v2``
    against JAX's."""
    cfg, jcfg = tf.PreprocessCfg(size=(32, 40)), jax_tf.PreprocessCfg(size=(32, 40))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.input_size == jcfg.input_size == (32, 40, 3)
    assert dataclasses.asdict(tf.AugmentationCfg()) == dataclasses.asdict(jax_tf.AugmentationCfg())
    overlay = {"size": 64, "mean": None, "bogus": 1, "interpolation": "bilinear"}
    assert tf.merge_preprocess_dict(cfg, overlay) == jax_tf.merge_preprocess_dict(jcfg, overlay)
    assert tf.merge_preprocess_dict(dict(overlay, mode="RGB"), None) == \
        jax_tf.merge_preprocess_dict(dict(overlay, mode="RGB"), None)
    assert tf.merge_preprocess_kwargs(cfg, size=16, std=None) == \
        jax_tf.merge_preprocess_kwargs(jcfg, size=16, std=None)
    got = tf.image_transform_v2(cfg, is_train=False)(_image())
    assert got.tobytes() == jax_tf.image_transform_v2(jcfg, is_train=False)(_image()).tobytes()


# ---------------------------------------------------------------- the registry


def test_registry_queries_match_jax():
    assert pretrained.list_pretrained() == jax_pre.list_pretrained()
    assert pretrained.list_pretrained(as_str=True) == jax_pre.list_pretrained(as_str=True)
    for model, tag in jax_pre.list_pretrained():
        assert pretrained.get_pretrained_cfg(model, tag) == jax_pre.get_pretrained_cfg(model, tag)
        assert pretrained.get_pretrained_url(model, tag) == jax_pre.get_pretrained_url(model, tag)
        assert pretrained.is_pretrained_cfg(model, tag.upper().replace("_", "-"))
        assert pretrained.list_pretrained_tags_by_model(model) == \
            jax_pre.list_pretrained_tags_by_model(model)
    for tag in ("openai", "OpenAI", "webli", "laion2b-s13b-b90k", "none"):
        assert pretrained.list_pretrained_models_by_tag(tag) == \
            jax_pre.list_pretrained_models_by_tag(tag)
    assert openai.list_openai_models() == jax_openai.list_openai_models() == ["ViT-B-32",
                                                                              "ViT-B-16"]
    assert not pretrained.get_pretrained_cfg("ViT-B-32", "nope")


def test_registry_converters_resolve():
    """Every row's converter names a callable of the port, the CoCa rows'
    the port's ``coca.load_torch_coca_weights``."""
    from instancediff_torch.models import coca

    n_coca = 0
    for model, tag in pretrained.list_pretrained():
        cfg = pretrained.get_pretrained_cfg(model, tag)
        conv = cfg.get("converter")
        if conv is None:
            assert pretrained.resolve_converter(cfg) is None
            continue
        fn = pretrained.resolve_converter(cfg)
        assert callable(fn) and fn.__module__.startswith("instancediff_torch.models")
        if fn.__name__ == "load_big_vision_weights":
            assert cfg["filename"].endswith(".npz")
        if conv.startswith("coca."):
            assert fn is coca.load_torch_coca_weights
            n_coca += 1
    assert n_coca == 4


def test_local_resolution_never_connects(tmp_path, monkeypatch):
    """With ``socket.socket`` raising: an absent asset raises
    FileNotFoundError with the provisioning note; one in ``cache_dir`` or
    ``$INSTANCEDIFF_ASSETS`` resolves, with its converter's name; an unknown
    tag raises KeyError, a cfg without a file ValueError."""
    def no_socket(*a, **k):
        raise AssertionError("a connection was opened")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("INSTANCEDIFF_ASSETS", raising=False)
    cfg = pretrained.get_pretrained_cfg("ViT-B-32", "openai")
    with pytest.raises(FileNotFoundError, match="no egress"):
        pretrained.download_pretrained(cfg, cache_dir=str(tmp_path))
    (tmp_path / "ViT-B-32.pt").write_bytes(b"x")
    path, got = pretrained.resolve_pretrained("ViT-B-32", "openai", cache_dir=str(tmp_path))
    assert path == str(tmp_path / "ViT-B-32.pt")
    assert got["converter"] == "text_encoder.load_torch_clip_text_weights"
    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "ViT-B-16.pt").write_bytes(b"x")
    monkeypatch.setenv("INSTANCEDIFF_ASSETS", str(assets))
    assert pretrained.resolve_pretrained("ViT-B-16", "openai")[0] == str(assets / "ViT-B-16.pt")
    with pytest.raises(KeyError):
        pretrained.resolve_pretrained("ViT-B-32", "nope")
    with pytest.raises(ValueError):
        pretrained.download_pretrained({"url": "", "hf_hub": "x"})


# ---------------------------------------------------------------- load_openai_model

W, EMBED = 32, 16  # the tiny towers' width and the checkpoint's embedding


def openai_state_dict(kind, seed=0):
    """A synthetic OpenAI CLIP state dict at the JAX tiny model's widths:
    the text tower (77 positions, cut to 16 by the loader) and a ViT
    (patch 8, a 4x4 grid, OpenAI naming) or an RN (width 8) visual."""
    rng = np.random.default_rng(seed)
    sd = {"token_embedding.weight": _t(rng, 512, W), "positional_embedding": _t(rng, 77, W),
          "ln_final.weight": _t(rng, W, mean=1.0), "ln_final.bias": _t(rng, W),
          "text_projection": _t(rng, W, EMBED), "logit_scale": torch.tensor(2.5)}

    def resblocks(prefix):
        for i in range(2):
            R = f"{prefix}transformer.resblocks.{i}."
            sd.update({R + "attn.in_proj_weight": _t(rng, 3 * W, W),
                       R + "attn.in_proj_bias": _t(rng, 3 * W),
                       R + "attn.out_proj.weight": _t(rng, W, W),
                       R + "attn.out_proj.bias": _t(rng, W),
                       R + "mlp.c_fc.weight": _t(rng, 4 * W, W), R + "mlp.c_fc.bias": _t(rng, 4 * W),
                       R + "mlp.c_proj.weight": _t(rng, W, 4 * W), R + "mlp.c_proj.bias": _t(rng, W),
                       R + "ln_1.weight": _t(rng, W, mean=1.0), R + "ln_1.bias": _t(rng, W),
                       R + "ln_2.weight": _t(rng, W, mean=1.0), R + "ln_2.bias": _t(rng, W)})

    resblocks("")
    if kind == "rn":
        sd.update(rn_state_dict(rng, width=8, embed=EMBED, grid=1))
    else:
        sd.update({"visual.conv1.weight": _t(rng, W, 3, 8, 8), "visual.class_embedding": _t(rng, W),
                   "visual.positional_embedding": _t(rng, 17, W),
                   "visual.ln_pre.weight": _t(rng, W, mean=1.0), "visual.ln_pre.bias": _t(rng, W),
                   "visual.ln_post.weight": _t(rng, W, mean=1.0),
                   "visual.ln_post.bias": _t(rng, W), "visual.proj": _t(rng, W, EMBED)})
        resblocks("visual.")
    return sd


@contextlib.contextmanager
def jax_inits_for_shapes():
    """While open, the jitted inits in JAX's ``BiomedCLIP.__init__`` are
    traced for shapes only (every leaf the loader does not set is then
    zero; the synthetic checkpoints set them all)."""
    real_jit = jax.jit

    def jit(fun, *args, **kwargs):
        if "BiomedCLIP.__init__" not in getattr(fun, "__qualname__", ""):
            return real_jit(fun, *args, **kwargs)
        return lambda *a: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                       jax.eval_shape(fun, *a))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", jit)
        yield


@pytest.mark.parametrize("kind,archive", [("vit", "state_dict"), ("rn", "state_dict"),
                                          ("rn", "torchscript")])
def test_load_openai_model_matches_jax(kind, archive, tmp_path):
    """``load_openai_model`` on a checkpoint file (``torch.save``d, or a
    ``torch.jit.save``d archive): the RN family detected from its
    ``visual.layer1.*`` keys, ``embed_dim`` and ``logit_scale`` read from it;
    image and text embeddings and the logits within 1e-5 of JAX's loader on
    the same file, the eval transform byte for byte."""
    sd = openai_state_dict(kind)
    path = tmp_path / f"tiny_{kind}.pt"
    (save_torchscript if archive == "torchscript" else torch.save)(sd, str(path))
    model, preprocess = openai.load_openai_model(str(path), tiny=True, device="cpu")
    with jax_inits_for_shapes():
        want, want_pre = jax_openai.load_openai_model(str(path), tiny=True)
    want._encode_image = jax.jit(lambda p, x: want.visual.apply(p, x))
    assert model.logit_scale == want.logit_scale == 2.5
    assert model.embed_dim == want.embed_dim == EMBED
    assert type(model.visual).__name__ == ("ModifiedResNet" if kind == "rn" else "CLIPVisionTower")
    if kind == "rn":
        assert openai._rn_geometry(sd) == (8, (1, 1, 1, 1))
    texts = ["speckle in OCT", "noise"]
    images = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    for got, ref in ((model.encode_image(images), want.encode_image(images)),
                     (model.encode_text(texts), want.encode_text(texts)),
                     (model(images, texts), want(images, texts))):
        _close(got, ref)
    assert preprocess(_image()).tobytes() == want_pre(_image()).tobytes()


def test_load_openai_model_refuses_an_unknown_name():
    for load in (openai.load_openai_model, jax_openai.load_openai_model):
        with pytest.raises(RuntimeError, match="not found"):
            load("NoSuchModel-Z9")


# ---------------------------------------------------------------- big_vision


def big_vision_npz(path, grid, width=32, layers=2, heads=4, patch=8, seed=0):
    rng = np.random.default_rng(seed)
    hd = width // heads

    def t(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    p = "params/img/"
    w = {p + "embedding/kernel": t(patch, patch, 3, width), p + "embedding/bias": t(width),
         p + "pos_embedding": t(1, grid * grid, width),
         p + "Transformer/encoder_norm/scale": t(width),
         p + "Transformer/encoder_norm/bias": t(width), p + "MAPHead_0/probe": t(1, 1, width)}
    for i in range(layers):
        bp = f"{p}Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_0/"
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            w[f"{bp}{ln}/scale"], w[f"{bp}{ln}/bias"] = t(width), t(width)
        for n in ("query", "key", "value"):
            w[f"{mha}{n}/kernel"], w[f"{mha}{n}/bias"] = t(width, heads, hd), t(heads, hd)
        w[mha + "out/kernel"], w[mha + "out/bias"] = t(heads, hd, width), t(width)
        w[bp + "MlpBlock_0/Dense_0/kernel"] = t(width, 4 * width)
        w[bp + "MlpBlock_0/Dense_0/bias"] = t(4 * width)
        w[bp + "MlpBlock_0/Dense_1/kernel"] = t(4 * width, width)
        w[bp + "MlpBlock_0/Dense_1/bias"] = t(width)
    np.savez(path, **w)


TINY_VIT = dict(image_size=32, patch_size=8, width=32, layers=2, heads=4, embed_dim=16)


@pytest.mark.parametrize("grid", [4, 5], ids=["on_grid", "resampled"])
def test_load_big_vision_weights_matches_jax(grid, tmp_path):
    """A SigLIP-layout ``.npz`` (cls-free position table, fused heads, MAP
    head) onto the tower: JAX's tree and skipped list (a 5x5 grid resized
    to 4x4 by the cubic resize); a wrong prefix raises KeyError."""
    tower = jax_vit.CLIPVisionTower(**TINY_VIT)
    tree = init(tower, jnp.zeros((1, 32, 32, 1)))
    path = str(tmp_path / "siglip.npz")
    big_vision_npz(path, grid)
    want, want_skipped = jax_bv.load_big_vision_weights(tree, path)
    port, skipped = big_vision.load_big_vision_weights(
        load_flax_params(clip_vit.CLIPVisionTower(**TINY_VIT), tree), path)
    assert skipped == want_skipped
    assert_trees_equal(flax_params(port)["params"], jax.tree.map(np.asarray, want["params"]),
                       resampled=("pos_embed",) if grid != 4 else ())
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), tower.apply(want, x))
    with pytest.raises(KeyError, match="not a big_vision checkpoint"):
        big_vision.load_big_vision_weights(port, path, prefix="params/txt/")


# ---------------------------------------------------------------- HF text towers


def hf_config(model_type, hidden=32, heads=4, layers=2, vocab=96, max_pos=20):
    names = jax_hf.ARCH_DICT[model_type]["config_names"]
    cfg = {"model_type": model_type, "layer_norm_eps": 1e-5 if "roberta" in model_type else None}
    for field, value in (("context_length", max_pos), ("vocab_size", vocab), ("width", hidden),
                         ("heads", heads), ("layers", layers)):
        if names.get(field):
            cfg[names[field]] = value
    return cfg


@pytest.mark.parametrize("model_type", sorted(jax_hf.ARCH_DICT))
def test_resolve_hf_text_cfg_matches_jax(model_type):
    """Every ``ARCH_DICT`` family resolves as in JAX (the table equal); the
    non-BERT families raise with their resolved dimensions at build time,
    an unknown arch raises KeyError."""
    assert hf_configs.ARCH_DICT == jax_hf.ARCH_DICT
    cfg = hf_config(model_type)
    assert hf_configs.resolve_hf_text_cfg(cfg) == jax_hf.resolve_hf_text_cfg(cfg)
    if hf_configs.ARCH_DICT[model_type]["encoder"] is None:
        with pytest.raises(NotImplementedError, match=model_type):
            hf_configs.build_hf_text_tower(cfg)
    with pytest.raises(KeyError):
        hf_configs.resolve_hf_text_cfg({"model_type": "gpt2"})


@pytest.mark.parametrize("model_type", ["bert", "roberta", "xlm-roberta"])
def test_build_hf_text_tower_matches_jax(model_type):
    """The tower ``build_hf_text_tower`` makes for a BERT-family config,
    against JAX's from the same tree, on 18 ids of a 20-row position table
    (roberta's rows start at 2: the offset reaches the table's end); for
    roberta the offset matters (an offset-0 tower differs)."""
    cfg = hf_config(model_type)
    jax_tower, jax_cfg = jax_hf.build_hf_text_tower(cfg, proj_dim=16)
    tower, got_cfg = hf_configs.build_hf_text_tower(cfg, proj_dim=16)
    assert got_cfg == jax_cfg
    assert tower.position_offset == jax_tower.position_offset == (0 if model_type == "bert"
                                                                  else 2)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 96, (3, 18)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 15:] = 0
    tree = init(jax_tower, ids, mask)
    load_flax_params(tower, tree)
    want = jax.jit(jax_tower.apply)(tree, ids, mask)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask))
        _close(got, want)
        if model_type != "bert":
            tower.position_offset = 0
            assert not torch.allclose(got, tower(torch.from_numpy(ids), torch.from_numpy(mask)))
