"""Parity of the port's tower breadth with the JAX package's on the CPU, at
the JAX tests' tiny widths: the RN family (``Bottleneck``,
``AttentionPool2d``, ``CLIPResNetWithAttention``, ``ModifiedResNet``), the
dense ViT (patch 16 and 8, on and off its grid, with and without
embeddings), the context decoders, the three torch-checkpoint loaders (bit
for bit against JAX's on the same synthetic state dict), the flax-tree
converters of the new modules, DropPath and PatchDropout on JAX's own draws,
and ``qkv_clamp``.

Every parameter leaf is drawn from a numpy seed. Tolerance: float32 outputs
within 1e-5 of the largest |output| (``_close``); loaders and converters
bit-equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.models import clip_vit as jax_clip_vit
from instancediff_tpu.models import text_encoder as jax_text
from instancediff_tpu.models import vision_towers as jvt
from instancediff_tpu.ops import attention as jax_attention

from instancediff_torch.models import clip_vit, text_encoder
from instancediff_torch.models import vision_towers as vt
from instancediff_torch.ops import attention
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import quick_jax_compiles  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, rng):
    """Every leaf redrawn: kernels ~ N(0, 1/fan_in), norm scales and
    BatchNorm variances ~ 1 + 0.1 N, everything else ~ its init + 0.1 N."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
            continue
        a = np.asarray(v, dtype=np.float32)
        if k == "kernel":
            r = rng.standard_normal(a.shape) / np.sqrt(int(np.prod(a.shape[:-1])))
        elif k in ("scale", "var"):
            r = 1.0 + 0.1 * rng.standard_normal(a.shape)
        else:
            r = a + 0.1 * rng.standard_normal(a.shape)
        out[k] = r.astype(np.float32)
    return out


def init(module, *args, seed=0):
    """``module``'s tree for ``args`` (traced for shapes only), redrawn."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    return randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                     np.random.default_rng(seed))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v, np.float32)
    return out


def assert_trees_equal(got, want, resampled=()):
    """Bit for bit, but for the ``resampled`` leaves (a position grid
    resized by ``jax.image.resize``), held within 1e-6 (8 float32 ulps) of
    their largest value: the port rounds the resize once from float64,
    XLA's dots round at each axis in an order that depends on the shapes."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        if "/".join(k) in resampled:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=2 ** -20 * np.abs(want[k]).max(), err_msg="/".join(k))
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _images(n, res, ch=1, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, ch)).astype(np.float32)


def _port(cls, tree, *args, **kw):
    return load_flax_params(cls(*args, **kw), tree)


# ---------------------------------------------------------------- the RN family


@pytest.mark.parametrize("inplanes,stride", [(8, 2), (8, 1), (16, 1)],
                         ids=["stride2", "widen", "identity"])
def test_bottleneck_matches_jax(inplanes, stride):
    """Strided (avg-pool shortcut), widening (1x1 shortcut) and identity
    shortcuts: within 1e-5."""
    x = _images(2, 8, inplanes)
    mod = jvt.Bottleneck(planes=4, stride=stride)
    tree = init(mod, x)
    port = _port(vt.Bottleneck, tree, inplanes, 4, stride)
    assert (port.downsample is None) == ("downsample" not in tree["params"])
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jax.jit(mod.apply)(tree, x))


def test_attention_pool_matches_jax():
    """Pooled embedding and tokens, 4 heads of 4."""
    x = _images(2, 4, 16)
    mod = jvt.AttentionPool2d(embed_dim=16, heads=4, out_dim=8)
    tree = init(mod, x)
    port = _port(vt.AttentionPool2d, tree, 16, 16, 16, heads=4, out_dim=8)
    want = jax.jit(mod.apply)(tree, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w)


def test_clip_resnet_matches_jax():
    """The four stage maps and the pooled embedding at width 8, 32 px (the
    stem's torch (1, 1) padding at stride 2)."""
    mod = jvt.CLIPResNetWithAttention(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4)
    tree = init(mod, _images(1, 32))
    x = _images(2, 32)
    port = _port(vt.CLIPResNetWithAttention, tree, (1, 1, 1, 1), 8, 16, 4, image_size=32,
                 in_ch=1)
    outs, pooled = jax.jit(mod.apply)(tree, x)
    with torch.no_grad():
        got_outs, got_pooled = port(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got_outs] == [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128),
                                                  (2, 1, 1, 256)]
    for g, w in zip(got_outs + [got_pooled], list(outs) + [pooled]):
        _close(g, w)


@pytest.mark.parametrize("res", [32, 64])
def test_modified_resnet_matches_jax(res):
    """open_clip's visual ResNet on [-1, 1] grey images (the OpenAI
    normalisation on device), at 32 px and at 64 px (a 2x2 final grid)."""
    mod = jvt.ModifiedResNet(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4,
                             openai_normalize=True)
    x = _images(2, res)
    tree = init(mod, x, seed=1)
    port = _port(vt.ModifiedResNet, tree, (1, 1, 1, 1), 8, 16, 4, openai_normalize=True,
                 image_size=res)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jax.jit(mod.apply)(tree, x))


# ---------------------------------------------------------------- the dense ViT

DENSE = dict(width=16, layers=4, heads=2, output_dim=12, out_indices=(0, 1, 2, 3))


@pytest.mark.parametrize("patch,grid,emb", [(16, "on", True), (16, "off", False),
                                            (8, "on", False), (8, "off", True)])
def test_dense_vit_matches_jax(patch, grid, emb):
    """The four neck maps (and the embeddings) at patch 16 and 8, on the
    position grid and off it (a 6x6 grid against the table's 4x4: the
    run-time bilinear resize)."""
    size = 4 * patch
    res = size if grid == "on" else 6 * patch
    mod = jvt.CLIPDenseVisionTransformer(image_size=size, patch_size=patch,
                                         get_embeddings=emb, **DENSE)
    tree = init(mod, _images(1, size), seed=patch)
    port = _port(vt.CLIPDenseVisionTransformer, tree, image_size=size, patch_size=patch,
                 get_embeddings=emb, **DENSE)
    x = _images(2, res)
    want = jax.jit(mod.apply)(tree, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 4 + emb
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    if emb:
        for g, w in zip(got[4], want[4]):
            _close(g, w)


# ---------------------------------------------------------------- the decoders


@pytest.mark.parametrize("kind", ["flat", "hierarchical"])
def test_context_decoder_matches_jax(kind):
    """``ContextDecoder`` over one memory and ``ContextDecoderHierarchical``
    over two scales of other widths (cross-attention on the plain path)."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 16)).astype(np.float32)
    if kind == "flat":
        mem = rng.standard_normal((2, 64, 16)).astype(np.float32)
        mod = jvt.ContextDecoder(dim=16, layers=2, heads=4)
        port = _port(vt.ContextDecoder, init(mod, q, mem), 16, 2, 4)
        port_mem = torch.from_numpy(mem)
    else:
        mem = [rng.standard_normal((2, 64, 12)).astype(np.float32),
               rng.standard_normal((2, 16, 24)).astype(np.float32)]
        mod = jvt.ContextDecoderHierarchical(dim=16, layers=1, heads=4, use_scales=(0, 1))
        port = _port(vt.ContextDecoderHierarchical, init(mod, q, mem), (12, 24), 16, 1, 4,
                     use_scales=(0, 1))
        port_mem = [torch.from_numpy(m) for m in mem]
    tree = init(mod, q, mem)
    with torch.no_grad():
        _close(port(torch.from_numpy(q), port_mem), jax.jit(mod.apply)(tree, q, mem))


REF = dict(width=32, heads=4, layers=2, visual_dim=24, text_dim=20, out_dim=16)


def _ref_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((2, 5, 20)).astype(np.float32),
            rng.standard_normal((2, 9, 24)).astype(np.float32))


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_context_decoder_ref_matches_jax(scaled):
    """``ContextDecoderRef`` with ``RefDecoderLayer``s (self-attention on the
    flash path, cross-attention on the plain one), gammas or not."""
    text, visual = _ref_inputs()
    mod = jvt.ContextDecoderRef(scaled=scaled, **REF)
    tree = init(mod, text, visual, seed=6)
    port = _port(vt.ContextDecoderRef, tree, scaled=scaled, **REF)
    with torch.no_grad():
        _close(port(torch.from_numpy(text), torch.from_numpy(visual)),
               jax.jit(mod.apply)(tree, text, visual))


# ---------------------------------------------------------------- converters


CONVERTER_CASES = {
    "frozen_bn_and_convs": (lambda: jvt.Bottleneck(planes=4, stride=2),
                            lambda: vt.Bottleneck(8, 4, 2), (_images(1, 8, 8),)),
    "attention_pool": (lambda: jvt.AttentionPool2d(embed_dim=16, heads=4, out_dim=8),
                       lambda: vt.AttentionPool2d(16, 16, 16, heads=4, out_dim=8),
                       (_images(1, 4, 16),)),
    "dense_vit_p16": (lambda: jvt.CLIPDenseVisionTransformer(image_size=64, patch_size=16,
                                                             get_embeddings=True, **DENSE),
                      lambda: vt.CLIPDenseVisionTransformer(image_size=64, patch_size=16,
                                                            get_embeddings=True, **DENSE),
                      (_images(1, 64),)),
    "context_decoder_ref": (lambda: jvt.ContextDecoderRef(scaled=True, **REF),
                            lambda: vt.ContextDecoderRef(scaled=True, **REF), _ref_inputs()),
}


@pytest.mark.parametrize("case", sorted(CONVERTER_CASES))
def test_flax_trees_round_trip(case):
    """A JAX tree of each new module into the port's module and back, bit for
    bit (FrozenBatchNorm's scale/bias/mean/var, HWIO -> OIHW convs, flax
    ConvTranspose kernels, the free tables and ``proj``)."""
    jax_mod, port_mod, args = CONVERTER_CASES[case]
    tree = init(jax_mod(), *args, seed=7)
    assert_trees_equal(flax_params(load_flax_params(port_mod(), tree)), tree)


# ---------------------------------------------------------------- loaders


def _t(rng, *shape, scale=0.2, mean=0.0):
    return torch.from_numpy((mean + scale * rng.standard_normal(shape)).astype(np.float32))


def _bn(sd, key, c, rng):
    sd[f"{key}.weight"] = _t(rng, c, mean=1.0)
    sd[f"{key}.bias"] = _t(rng, c)
    sd[f"{key}.running_mean"] = _t(rng, c)
    sd[f"{key}.running_var"] = _t(rng, c, scale=0.1, mean=1.0)


def rn_state_dict(rng, width=8, layers=(1, 1, 1, 1), embed=16, grid=1, prefix="visual."):
    """A synthetic OpenAI ``ModifiedResNet`` visual state dict."""
    sd, w = {}, width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        sd[f"conv{i}.weight"] = _t(rng, cout, cin, 3, 3)
        _bn(sd, f"bn{i}", cout, rng)
    inp = w
    for s, n in enumerate(layers):
        planes = w * 2 ** s
        for b in range(n):
            L = f"layer{s + 1}.{b}"
            sd[f"{L}.conv1.weight"] = _t(rng, planes, inp, 1, 1)
            sd[f"{L}.conv2.weight"] = _t(rng, planes, planes, 3, 3)
            sd[f"{L}.conv3.weight"] = _t(rng, planes * 4, planes, 1, 1)
            for j, c in ((1, planes), (2, planes), (3, planes * 4)):
                _bn(sd, f"{L}.bn{j}", c, rng)
            if b == 0:
                sd[f"{L}.downsample.0.weight"] = _t(rng, planes * 4, inp, 1, 1)
                _bn(sd, f"{L}.downsample.1", planes * 4, rng)
            inp = planes * 4
    C = w * 32
    sd["attnpool.positional_embedding"] = _t(rng, grid * grid + 1, C)
    for name in ("q_proj", "k_proj", "v_proj"):
        sd[f"attnpool.{name}.weight"] = _t(rng, C, C, scale=0.05)
        sd[f"attnpool.{name}.bias"] = _t(rng, C)
    sd["attnpool.c_proj.weight"] = _t(rng, embed, C, scale=0.05)
    sd["attnpool.c_proj.bias"] = _t(rng, embed)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("grid,res", [(1, 32), (3, 64)], ids=["on_grid", "off_grid"])
def test_resnet_loader_matches_jax(grid, res):
    """``load_torch_clip_resnet_weights`` onto ``ModifiedResNet``: the same
    tree as JAX's loader bit for bit, the attention pool's 3x3 checkpoint
    grid resampled to the model's 2x2 at 64 px (``assert_trees_equal``'s
    resampled leaves); the loaded models agree."""
    mod = jvt.ModifiedResNet(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4,
                             openai_normalize=True)
    x = _images(2, res)
    tree = init(mod, x)
    sd = rn_state_dict(np.random.default_rng(8), grid=grid)
    want = jvt.load_torch_clip_resnet_weights(tree["params"], sd)
    port = vt.load_torch_clip_resnet_weights(
        vt.ModifiedResNet((1, 1, 1, 1), 8, 16, 4, openai_normalize=True, image_size=res), sd)
    assert_trees_equal(flax_params(port)["params"], want,
                       resampled=("trunk/attnpool/positional_embedding",) if grid > 1 else ())
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), jax.jit(mod.apply)({"params": want}, x))


def dense_vit_state_dict(rng, patch, width=16, layers=4, embed=12, grid=4, prefix="visual."):
    """A synthetic reference ``CLIPVisionTransformer`` state dict, necks
    included (torch's Sequential indices)."""
    sd = {"conv1.weight": _t(rng, width, 3, patch, patch),
          "class_embedding": _t(rng, width), "positional_embedding": _t(rng, grid * grid + 1,
                                                                        width),
          "ln_pre.weight": _t(rng, width, mean=1.0), "ln_pre.bias": _t(rng, width),
          "ln_post.weight": _t(rng, width, mean=1.0), "ln_post.bias": _t(rng, width),
          "proj": _t(rng, width, embed)}
    for i in range(layers):
        R = f"transformer.resblocks.{i}."
        sd.update({R + "attn.in_proj_weight": _t(rng, 3 * width, width),
                   R + "attn.in_proj_bias": _t(rng, 3 * width),
                   R + "attn.out_proj.weight": _t(rng, width, width),
                   R + "attn.out_proj.bias": _t(rng, width),
                   R + "mlp.c_fc.weight": _t(rng, 4 * width, width),
                   R + "mlp.c_fc.bias": _t(rng, 4 * width),
                   R + "mlp.c_proj.weight": _t(rng, width, 4 * width),
                   R + "mlp.c_proj.bias": _t(rng, width),
                   R + "ln_1.weight": _t(rng, width, mean=1.0), R + "ln_1.bias": _t(rng, width),
                   R + "ln_2.weight": _t(rng, width, mean=1.0), R + "ln_2.bias": _t(rng, width)})

    def gn(key):
        sd[key + ".weight"], sd[key + ".bias"] = _t(rng, width, mean=1.0), _t(rng, width)

    def deconv(key):
        sd[key + ".weight"], sd[key + ".bias"] = _t(rng, width, width, 2, 2), _t(rng, width)

    if patch == 16:
        gn("fpn1.0"), deconv("fpn1.1"), deconv("fpn1.4"), gn("fpn2.0"), deconv("fpn2.1")
        gn("fpn3"), gn("fpn4.0")
        _bn(sd, "fpn1.2", width, rng)
    else:
        gn("fpn1.0"), deconv("fpn1.1"), gn("fpn2"), gn("fpn3.0"), gn("fpn4.0")
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("patch,grid", [(16, 4), (8, 5)], ids=["p16", "p8_resampled"])
def test_dense_vit_loader_matches_jax(patch, grid):
    """``load_torch_dense_vit_weights`` with the necks (torch ConvTranspose2d
    weights), the position table at the tower's grid and resampled from a
    5x5 one (``assert_trees_equal``'s resampled leaves): JAX's tree bit for
    bit; the loaded towers agree."""
    size = 4 * patch
    mod = jvt.CLIPDenseVisionTransformer(image_size=size, patch_size=patch,
                                         get_embeddings=True, **DENSE)
    tree = init(mod, _images(1, size))
    sd = dense_vit_state_dict(np.random.default_rng(9), patch, grid=grid)
    want = jvt.load_torch_dense_vit_weights(tree["params"], sd)
    port = vt.load_torch_dense_vit_weights(
        vt.CLIPDenseVisionTransformer(image_size=size, patch_size=patch, get_embeddings=True,
                                      **DENSE), sd)
    assert_trees_equal(flax_params(port)["params"], want,
                       resampled=("positional_embedding",) if grid != 4 else ())
    x = _images(2, size)
    got = port(torch.from_numpy(x))
    for g, w in zip(got[:4], jax.jit(mod.apply)({"params": want}, x)[:4]):
        _close(g, w)


def context_decoder_state_dict(rng, layers, hierarchical):
    """A synthetic torch ``ContextDecoder`` (or hierarchical, with gammas and
    a second, unused memory projection) state dict at ``REF``'s widths."""
    W, V, T, O = REF["width"], REF["visual_dim"], REF["text_dim"], REF["out_dim"]
    sd = {}

    def lin(key, o, i):
        sd[key + ".weight"], sd[key + ".bias"] = _t(rng, o, i), _t(rng, o)

    def ln(key, c):
        sd[key + ".weight"], sd[key + ".bias"] = _t(rng, c, mean=1.0), _t(rng, c)

    for mp in (("memory_proj_0", "memory_proj_1") if hierarchical else ("memory_proj",)):
        ln(mp + ".0", V), lin(mp + ".1", W, V), ln(mp + ".2", W)
    ln("text_proj.0", T), lin("text_proj.1", W, T)
    for i in range(layers):
        t = f"decoder.{i}"
        for n in ("norm1", "norm2", "norm3"):
            ln(f"{t}.{n}", W)
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q_proj", "k_proj", "v_proj"):
                sd[f"{t}.{attn}.{proj}.weight"] = _t(rng, W, W)
            lin(f"{t}.{attn}.proj", W, W)
        lin(f"{t}.mlp.0", 4 * W, W), lin(f"{t}.mlp.3", W, 4 * W)
        if hierarchical:
            for g in ("gamma_sa", "gamma_ca", "gamma_mlp"):
                sd[f"{t}.{g}"] = _t(rng, 1, 1, W, mean=0.1)
    ln("out_proj.0", W), lin("out_proj.1", O, W)
    return sd


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hierarchical"])
def test_context_decoder_loader_matches_jax(hierarchical):
    """``load_torch_context_decoder_weights``: JAX's tree bit for bit (the
    hierarchical dict's scale-0 projection and gammas); the loaded decoders
    agree."""
    text, visual = _ref_inputs()
    mod = jvt.ContextDecoderRef(scaled=hierarchical, **REF)
    tree = init(mod, text, visual)
    sd = context_decoder_state_dict(np.random.default_rng(10), REF["layers"], hierarchical)
    want = jvt.load_torch_context_decoder_weights(tree["params"], sd, REF["layers"])
    port = vt.load_torch_context_decoder_weights(vt.ContextDecoderRef(scaled=hierarchical,
                                                                      **REF), sd)
    assert_trees_equal(flax_params(port)["params"], want)
    with torch.no_grad():
        _close(port(torch.from_numpy(text), torch.from_numpy(visual)),
               jax.jit(mod.apply)({"params": want}, text, visual))


# ---------------------------------------------------------------- DropPath, PatchDropout


def test_drop_path_matches_jax():
    """JAX's ``drop_path`` on its key against the port's on JAX's uniform
    draw; from a torch.Generator: each sample kept (scaled by 1/keep) or
    zeroed, the same generator seed the same result; identity at rate 0."""
    x = np.random.default_rng(11).standard_normal((6, 5, 8)).astype(np.float32)
    key = jax.random.key(3)
    want = jax_attention.drop_path(key, jnp.asarray(x), 0.5)
    u = jax.random.uniform(key, (6, 1, 1), dtype=jnp.float32)
    _close(attention.drop_path(torch.from_numpy(x), 0.5, iter([np.asarray(u)])), want, 1e-6)
    xt = torch.from_numpy(x)
    got = attention.drop_path(xt, 0.5, torch.Generator().manual_seed(0))
    for b in range(6):
        assert torch.equal(got[b], xt[b] * 2) or not got[b].any()
    assert torch.equal(got, attention.drop_path(xt, 0.5, torch.Generator().manual_seed(0)))
    assert attention.drop_path(xt, 0.0) is xt


@pytest.mark.parametrize("prob,exclude_first", [(0.5, True), (0.3, False), (0.9, True)])
def test_patch_dropout_matches_jax(prob, exclude_first):
    """The kept tokens in the order of JAX's normal draw's top-k, the class
    token kept when excluded: equal to JAX's."""
    x = np.random.default_rng(12).standard_normal((3, 17, 8)).astype(np.float32)
    key = jax.random.key(4)
    want = jax_clip_vit.patch_dropout_tokens(key, jnp.asarray(x), prob, exclude_first)
    n = 16 if exclude_first else 17
    draw = np.asarray(jax.random.normal(key, (3, n)))
    got = clip_vit.patch_dropout_tokens(torch.from_numpy(x), prob, iter([draw]), exclude_first)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _record_draws(monkeypatch, draws):
    """Record, in call order, the draws JAX's ``drop_path`` and
    ``patch_dropout_tokens`` make from their keys."""
    real_dp, real_pd = jax_text.drop_path, jax_clip_vit.patch_dropout_tokens

    def dp(key, x, rate):
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        draws.append(np.asarray(jax.random.uniform(key, shape, dtype=x.dtype)))
        return real_dp(key, x, rate)

    def pd(key, x, prob, exclude_first_token=True):
        n = x.shape[1] - (1 if exclude_first_token else 0)
        draws.append(np.asarray(jax.random.normal(key, (x.shape[0], n))))
        return real_pd(key, x, prob, exclude_first_token)

    monkeypatch.setattr(jax_text, "drop_path", dp)
    monkeypatch.setattr(jax_clip_vit, "patch_dropout_tokens", pd)


def test_transformer_block_drop_path_matches_jax(monkeypatch):
    """A block in train mode (``drop_path_rate`` 0.5, LayerScale on) on
    JAX's two draws; in eval mode the branches pass whole."""
    draws = []
    _record_draws(monkeypatch, draws)
    x = np.random.default_rng(13).standard_normal((8, 6, 16)).astype(np.float32)
    mod = jax_text.TransformerBlock(16, 2, drop_path_rate=0.5, ls_init=0.5)
    tree = init(mod, x)
    want = mod.apply(tree, x, deterministic=False, rngs={"drop_path": jax.random.key(5)})
    assert len(draws) == 2
    port = _port(text_encoder.TransformerBlock, tree, 16, 2, drop_path_rate=0.5, ls_init=0.5)
    with torch.no_grad():
        _close(port(torch.from_numpy(x), deterministic=False, rng=iter(draws)), want)
        _close(port(torch.from_numpy(x)), jax.jit(mod.apply)(tree, x))


TINY_VIT = dict(image_size=32, patch_size=8, width=32, layers=3, heads=4, embed_dim=16)


def test_vision_tower_train_mode_matches_jax(monkeypatch):
    """``CLIPVisionTower(patch_dropout=0.5, drop_path_rate=0.2)`` with
    ``deterministic=False`` on JAX's draws (PatchDropout's, then each
    block's; JAX's tower built with the port's per-block rates, 0 at the
    first block rising to 0.2 at the last); from a generator: the kept
    token count, and the same seed the same embedding."""
    draws = []
    _record_draws(monkeypatch, draws)
    port = clip_vit.CLIPVisionTower(patch_dropout=0.5, drop_path_rate=0.2, **TINY_VIT)
    rates = [getattr(port, f"block_{i}").drop_path_rate for i in range(3)]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.2)

    def block(width, heads, name=None, **kw):
        return jax_text.TransformerBlock(width, heads, name=name,
                                         drop_path_rate=rates[int(name.split("_")[1])], **kw)

    monkeypatch.setattr(jax_clip_vit, "TransformerBlock", block)
    mod = jax_clip_vit.CLIPVisionTower(patch_dropout=0.5, **TINY_VIT)
    x = _images(4, 32)
    tree = init(mod, x)
    key_pd, key_dp = jax.random.split(jax.random.key(6))
    want = mod.apply(tree, x, deterministic=False,
                     rngs={"patch_dropout": key_pd, "drop_path": key_dp})
    assert len(draws) == 1 + 2 * 2  # blocks 1 and 2 draw, block 0 (rate 0) does not
    load_flax_params(port, tree)
    seen = []
    real = clip_vit.patch_dropout_tokens
    monkeypatch.setattr(clip_vit, "patch_dropout_tokens",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    with torch.no_grad():
        _close(port(torch.from_numpy(x), deterministic=False, rng=iter(draws)), want)
        assert seen[-1].shape == (4, 1 + 8, 32)  # max(1, int(16 * 0.5)) patches + class
        a = port(torch.from_numpy(x), deterministic=False, rng=torch.Generator().manual_seed(1))
        b = port(torch.from_numpy(x), deterministic=False, rng=torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        _close(port(torch.from_numpy(x)), jax.jit(mod.apply)(tree, x))
    with pytest.raises(ValueError, match="needs rng"):
        port(torch.from_numpy(x), deterministic=False)


# ---------------------------------------------------------------- qkv_clamp


@pytest.mark.parametrize("masked", [False, True], ids=["flash_path", "masked_path"])
def test_qkv_clamp_matches_jax(masked):
    """``qkv_clamp=255`` on inputs whose q/k/v pass 255 (kernels scaled up):
    the clamped block equals JAX's, on the unmasked (flash) path and the
    masked (causal) one, and differs from the unclamped block."""
    x = np.random.default_rng(14).standard_normal((2, 6, 16)).astype(np.float32)
    mod = jax_text.TransformerBlock(16, 2, qkv_clamp=255.0)
    tree = init(mod, x)
    for name in ("q_proj", "k_proj", "v_proj"):
        tree["params"][name]["kernel"] *= 400.0
    mask = (np.where(np.tril(np.ones((6, 6), bool)), 0.0, -np.inf)[None].astype(np.float32)
            if masked else None)
    want = jax.jit(mod.apply)(tree, x, mask=mask)
    port = _port(text_encoder.TransformerBlock, tree, 16, 2, qkv_clamp=255.0)
    free = _port(text_encoder.TransformerBlock, tree, 16, 2)
    with torch.no_grad():
        m = None if mask is None else torch.from_numpy(mask)
        q = port.q_proj(torch.nn.functional.layer_norm(torch.from_numpy(x), (16,),
                                                       port.ln_1.weight, port.ln_1.bias,
                                                       port.ln_1.eps))
        assert q.abs().max() > 255
        got = port(torch.from_numpy(x), mask=m)
        _close(got, want)
        assert not torch.allclose(got, free(torch.from_numpy(x), mask=m))
