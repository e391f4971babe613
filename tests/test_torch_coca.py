"""Parity of the port's CoCa (``instancediff_torch/models/coca.py``) with the
JAX package's on the CPU, at ``build_coca(tiny=True)``: the forward dict,
the image-only pair, ``encode_text`` and ``decode`` (fp32 within 1e-5 of the
largest |output|; bf16 within 1e-2), the decoder's causality, ``generate``
(top-k, top-p on JAX's own per-step Gumbel draws, ``min_seq_len``,
``repetition_penalty``) and beam search token for token, the open_clip
loader against JAX's on the same synthetic state dict (both pooler layouts;
leaf for leaf, bit for bit) and the registry's converter.

Every parameter leaf is drawn from a numpy seed; the JAX references are
built once for the module and jitted."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from instancediff_tpu.models import coca as jcoca

from instancediff_torch.models import coca, pretrained
from instancediff_torch.utils.convert import flax_params, load_flax_params

from test_torch_engine import one_torch_thread, quick_jax_compiles  # noqa: F401
from test_torch_vision_towers import _close, assert_trees_equal, randomize

SOT, EOS, PAD = 1, 2, 0
IDS = np.array([[1, 5, 9, 3, 0, 0, 0, 0], [1, 7, 2, 8, 4, 6, 0, 0]], np.int32)


@pytest.fixture(scope="module")
def ref():
    """JAX's tiny CoCa (its tree traced for shapes only, every leaf redrawn),
    its jitted methods, the port's CoCa holding the same tree, and the
    images."""
    model = jcoca.build_coca(tiny=True)
    imgs = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 1)).astype(np.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(1), imgs, IDS)
    tree = randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                     np.random.default_rng(1))
    port = load_flax_params(coca.build_coca(tiny=True, device="cpu"), tree)
    fns = {name: jax.jit(functools.partial(model.apply, method=name))
           for name in ("__call__", "encode_image", "encode_text", "decode")}
    return dict(model=model, tree=tree, port=port, imgs=imgs, fns=fns)


def _t(a):
    return torch.from_numpy(np.array(a))


def _outputs(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "labels":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            _close(got[k], want[k])


@pytest.mark.parametrize("what", ["forward", "image_only", "encode_image", "encode_text",
                                  "decode"])
def test_matches_jax(ref, what):
    """The forward dict (all five outputs), the image-only pair, the two
    encoders (normalised latents and tokens) and ``decode``'s logits."""
    port, tree, fns, imgs = ref["port"], ref["tree"], ref["fns"], ref["imgs"]
    with torch.no_grad():
        if what == "forward":
            _outputs(port(_t(imgs), _t(IDS)), fns["__call__"](tree, imgs, IDS))
        elif what == "image_only":
            _outputs(port(_t(imgs)), fns["__call__"](tree, imgs))
        elif what in ("encode_image", "encode_text"):
            arg = imgs if what == "encode_image" else IDS
            for g, w in zip(getattr(port, what)(_t(arg)), fns[what](tree, arg), strict=True):
                _close(g, w)
        else:
            embs = fns["encode_image"](tree, imgs)[1]
            _close(port.decode(_t(embs), _t(IDS)), fns["decode"](tree, embs, IDS))


def test_forward_contract(ref):
    """The reference's return dict: shapes, labels, unit-norm latents,
    ``logit_scale`` the exponential of the parameter."""
    port, imgs = ref["port"], ref["imgs"]
    with torch.no_grad():
        out = port(_t(imgs), _t(IDS))
    assert out["logits"].shape == (2, IDS.shape[1], port.vocab_size)
    assert out["image_features"].shape == out["text_features"].shape == (2, port.embed_dim)
    np.testing.assert_allclose(out["image_features"].norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert out["logit_scale"].item() == pytest.approx(np.exp(ref["tree"]["params"][
        "logit_scale"]), rel=1e-6)
    assert port(_t(imgs))["image_embs"].shape == (2, port.n_queries - 1, port.embed_dim)


def test_bf16_forward_matches_jax(ref):
    """``dtype=bfloat16`` (float32 parameters, 16-bit compute) against JAX's
    bf16 CoCa on the same tree: the unit-norm latents within 1e-2 (BiomedCLIP's
    bf16 tolerance) of JAX's bf16 and fp32 models; the logits (up to ~3 in
    size, through four bf16 layers) no farther from JAX's fp32 logits than
    twice JAX's own bf16 logits lie from them."""
    model = jcoca.build_coca(tiny=True, dtype=jnp.bfloat16)
    want = jax.jit(model.apply)(ref["tree"], ref["imgs"], IDS)
    full = ref["fns"]["__call__"](ref["tree"], ref["imgs"], IDS)
    port = load_flax_params(coca.build_coca(tiny=True, dtype=torch.bfloat16, device="cpu"),
                            ref["tree"])
    with torch.no_grad():
        got = port(_t(ref["imgs"]), _t(IDS))
    assert got["logits"].dtype == torch.bfloat16 and want["logits"].dtype == jnp.bfloat16
    for k in ("image_features", "text_features"):
        for other in (want[k], full[k]):
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(other, np.float32),
                                       rtol=0, atol=1e-2)
    logits, jax16, jax32 = (np.asarray(a, np.float32) for a in (got["logits"].float(),
                                                                 want["logits"], full["logits"]))
    assert np.abs(logits - jax32).max() <= 2 * np.abs(jax16 - jax32).max()


def test_decoder_causality(ref):
    """Logits at position i do not depend on tokens after i (the causal masks
    of the text tower and the decoder)."""
    port, imgs = ref["port"], _t(ref["imgs"])
    ids2 = IDS.copy()
    ids2[:, 5] = 13
    with torch.no_grad():
        base = port(imgs, _t(IDS))["logits"]
        pert = port(imgs, _t(ids2))["logits"]
    np.testing.assert_allclose(base[:, :5].numpy(), pert[:, :5].numpy(), atol=1e-5)
    assert (base[:, 5:] - pert[:, 5:]).abs().max() > 1e-6


def _jax_gumbel(key, steps, shape):
    """The Gumbel draws JAX's ``generate`` adds at each step: ``k, sub =
    split(k)``, then ``categorical``'s ``gumbel(sub, logits.shape)``."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return out


GENERATE_CASES = {
    "top_k1": dict(seq_len=10, generation_type="top_k", top_k=1, min_seq_len=2),
    "top_k3": dict(seq_len=12, generation_type="top_k", top_k=3, min_seq_len=2),
    "top_p": dict(seq_len=8, generation_type="top_p", top_p=0.5, min_seq_len=2,
                  temperature=0.7),
    "min_seq_len": dict(seq_len=12, generation_type="top_k", top_k=3, min_seq_len=6),
    "repetition_penalty": dict(seq_len=10, generation_type="top_k", top_k=1,
                               min_seq_len=2, repetition_penalty=1.3),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_matches_jax(ref, case):
    """Tokens equal JAX's ``generate``; the sampling cases on JAX's own
    per-step draws. The fixed-shape contract: SOT first, after the first
    EOS or PAD only PAD, EOS forced at the end of an unfinished row, no EOS
    before ``min_seq_len``."""
    kw = dict(GENERATE_CASES[case], sot_token_id=SOT, eos_token_id=EOS, pad_token_id=PAD)
    model, tree, imgs = ref["model"], ref["tree"], ref["imgs"]
    key = jax.random.key(3)
    want = np.asarray(jax.jit(lambda p, x, k: jcoca.generate(model, p, x, k, **kw))(
        tree, imgs, key))
    greedy = kw.get("top_k") == 1
    rng = (torch.Generator().manual_seed(0) if greedy
           else iter(_jax_gumbel(key, kw["seq_len"] - 1, (2, model.vocab_size))))
    got = coca.generate(ref["port"], _t(imgs), rng, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for row in want:
        assert row[0] == SOT
        stop = np.flatnonzero((row[1:] == EOS) | (row[1:] == PAD))
        assert len(stop) and (row[1:][stop[0] + 1:] == PAD).all()
        eos = np.flatnonzero(row == EOS)
        assert not len(eos) or eos[0] >= kw["min_seq_len"]


def test_generate_refuses_unknown_type_and_missing_rng(ref):
    with pytest.raises(ValueError, match="generation_type"):
        coca.generate(ref["port"], _t(ref["imgs"]), torch.Generator(), generation_type="greedy",
                      seq_len=8, sot_token_id=SOT, eos_token_id=EOS, pad_token_id=PAD)
    with pytest.raises(ValueError, match="rng"):
        coca.generate(ref["port"], _t(ref["imgs"]))


@pytest.mark.parametrize("beams,groups", [(4, 2), (1, 1)], ids=["4x2", "1x1"])
def test_beam_search_matches_jax(ref, beams, groups):
    """Tokens equal JAX's ``generate_beamsearch`` (8 positions)."""
    kw = dict(seq_len=8, num_beams=beams, num_beam_groups=groups, min_seq_len=2,
              sot_token_id=SOT, eos_token_id=EOS, pad_token_id=PAD)
    model = ref["model"]
    want = np.asarray(jax.jit(lambda p, x: jcoca.generate_beamsearch(model, p, x, **kw))(
        ref["tree"], ref["imgs"]))
    got = coca.generate(ref["port"], _t(ref["imgs"]), generation_type="beam_search", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == SOT).all()


def test_beam_ties_take_the_lower_index():
    """Equal candidates come out lowest index first, as ``lax.top_k`` gives
    them."""
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0]])
    v, i = coca._top_k_lowest_first(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))


def _open_clip_sd(model, pooler: str):
    """JAX's synthetic open_clip-layout dict (``tests/test_coca.py``), its
    pooler in the kdim layout (``q_proj_weight`` ...) or the fused
    ``in_proj_weight`` layout, plus the vision trunk and the decoder's
    blocks."""
    rng = np.random.default_rng(0)
    W, E, VW, V = model.text_width, model.embed_dim, model.vision_width, model.vocab_size
    n = rng.normal
    sd = {
        "text.token_embedding.weight": n(size=(V, W)), "text.cls_emb": n(size=(W,)),
        "text.positional_embedding": n(size=(model.context_length + 1, W)),
        "text.ln_final.weight": n(size=(W,)), "text.ln_final.bias": n(size=(W,)),
        "text.text_projection": n(size=(W, E)),
        "text.transformer.resblocks.0.attn.in_proj_weight": n(size=(3 * W, W)),
        "text.transformer.resblocks.0.attn.in_proj_bias": n(size=(3 * W,)),
        "text.transformer.resblocks.0.attn.out_proj.weight": n(size=(W, W)),
        "text.transformer.resblocks.0.attn.out_proj.bias": n(size=(W,)),
        "text_decoder.cross_attn.0.ln_1_kv.weight": n(size=(W,)),
        "text_decoder.cross_attn.0.ln_1_kv.bias": n(size=(W,)),
        "text_decoder.cross_attn.1.attn.in_proj_weight": n(size=(3 * W, W)),
        "text_decoder.cross_attn.1.attn.in_proj_bias": n(size=(3 * W,)),
        "text_decoder.resblocks.1.mlp.c_fc.weight": n(size=(4 * W, W)),
        "text_decoder.resblocks.1.mlp.c_fc.bias": n(size=(4 * W,)),
        "text_decoder.text_projection": n(size=(W, V)),
        "text_decoder.ln_final.weight": n(size=(W,)), "text_decoder.ln_final.bias": n(size=(W,)),
        "module.visual.conv1.weight": n(size=(VW, 3, model.patch_size, model.patch_size)),
        "visual.class_embedding": n(size=(VW,)),
        "visual.positional_embedding": n(size=(5, VW)),
        "visual.ln_pre.weight": n(size=(VW,)), "visual.ln_pre.bias": n(size=(VW,)),
        "visual.transformer.resblocks.1.ln_2.weight": n(size=(VW,)),
        "visual.transformer.resblocks.1.ln_2.bias": n(size=(VW,)),
        "visual.proj": n(size=(E, E)),
        "visual.attn_pool.query": n(size=(model.n_queries, E)),
        "visual.attn_pool.ln_k.weight": n(size=(VW,)), "visual.attn_pool.ln_k.bias": n(size=(VW,)),
        "visual.attn_pool.attn.out_proj.weight": n(size=(E, E)),
        "visual.attn_pool.attn.out_proj.bias": n(size=(E,)),
        "logit_scale": np.asarray(0.5),
    }
    if pooler == "kdim":
        sd.update({"visual.attn_pool.attn.q_proj_weight": n(size=(E, E)),
                   "visual.attn_pool.attn.k_proj_weight": n(size=(E, VW)),
                   "visual.attn_pool.attn.v_proj_weight": n(size=(E, VW)),
                   "visual.attn_pool.attn.in_proj_bias": n(size=(3 * E,))})
    else:
        sd.update({"visual.attn_pool.attn.in_proj_weight": n(size=(3 * E, VW)),
                   "visual.attn_pool.attn.in_proj_bias": n(size=(3 * E,))})
    return sd


@pytest.mark.parametrize("pooler", ["kdim", "in_proj"])
def test_loader_matches_jax(ref, pooler):
    """The port's loader and JAX's on the same state dict (the ``module.``
    prefix stripped, present keys only): every leaf bit-equal, then both
    forwards within 1e-5."""
    model, tree = ref["model"], ref["tree"]
    sd = _open_clip_sd(model, pooler)
    want = jcoca.load_torch_coca_weights(tree, sd)
    port = load_flax_params(coca.build_coca(tiny=True, device="cpu"), tree)
    assert coca.load_torch_coca_weights(port, sd) is port
    assert_trees_equal(flax_params(port)["params"], jax.tree.map(np.asarray, want["params"]))
    with torch.no_grad():
        _outputs(port(_t(ref["imgs"]), _t(IDS)), ref["fns"]["__call__"](want, ref["imgs"], IDS))


def test_loader_reads_a_file(ref, tmp_path):
    """A ``torch.save``d checkpoint under ``"state_dict"`` loads as the
    mapping does; a missing path raises."""
    sd = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in _open_clip_sd(ref["model"], "kdim").items()}
    path = tmp_path / "coca.pt"
    torch.save({"state_dict": sd}, path)
    a = coca.load_torch_coca_weights(copy.deepcopy(ref["port"]), str(path))
    b = coca.load_torch_coca_weights(copy.deepcopy(ref["port"]), sd)
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    with pytest.raises(FileNotFoundError):
        coca.load_torch_coca_weights(a, str(tmp_path / "absent.pt"))


def test_registry_resolves_the_port_loader():
    for model, tag in pretrained.list_pretrained():
        if model.startswith("coca_"):
            cfg = pretrained.get_pretrained_cfg(model, tag)
            assert pretrained.resolve_converter(cfg) is coca.load_torch_coca_weights
    assert pretrained.resolve_converter(pretrained.get_pretrained_cfg(
        "coca_ViT-B-32", "laion2b_s13b_b90k")) is coca.load_torch_coca_weights
