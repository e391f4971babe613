"""Parity of the port's BiomedCLIP pieces with the JAX package's on the CPU:
the WordPiece tokenizer, the PubMedBERT tower (``HFContextTextEncoder``) and
its torch-checkpoint loader, the DDPM engine with ``CLIP_Type: BiomedCLIP``,
the ``BiomedCLIP`` wrapper and ``tools/precompute_embeddings``; and a train
step of both engines with the BERT tower.

Every parameter leaf is drawn from a numpy seed; the JAX DDPM engine is built
once, its inits traced for shapes only."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import instancediff_tpu.models.biomedclip as jax_biomedclip
from instancediff_tpu.models import text_encoder as jax_text
from instancediff_tpu.models import tokenizer as jax_tok
from instancediff_tpu.models.ddpm_model import CLIPDDPMEngine as JaxDDPMEngine
from instancediff_tpu.sde import DDPMSDE as JaxDDPMSDE

import chip_smoke
from instancediff_torch.models import biomedclip, text_encoder, tokenizer
from instancediff_torch.models.ddpm_model import CLIPDDPMEngine
from instancediff_torch.models.drift_model import CLIPDriftEngine
from instancediff_torch.sde import DDPMSDE, DriftSDE
from instancediff_torch.tools import precompute_embeddings
from instancediff_torch.utils.checkpoint import load_pytree
from instancediff_torch.utils.convert import flax_params, load_engine, load_flax_params

from test_torch_engine import (_jax_noise, inits_shapes_only, one_torch_thread,  # noqa: F401
                               quick_jax_compiles, randomize)

RES, B, T = 16, 2, 4
SETTINGS = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1, 2], context_dim=16,
                text_module="scoremap", score_map_chan=4, score_map_ngf=8, num_res_blocks=1)
TINY_BERT = dict(hidden=48, heads=4, layers=2, proj_dim=16, vocab_size=512,
                 context_length=32, max_position=64)
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "speckle", "noise", "in", "oct", "ultra", "sound",
         "cry", "##o", "-", "em", "image", "low", "dose", "ct", "gaussian", "mri", "##s",
         "##ound", "ul", "##tra", "##und", "mr", "##i"]
TEXTS = ["speckle in OCT", "noise in cryo-EM image", "Ultrasounds in low dose CT!",
         "Gaussian noise in MRI", "xyzzy speckles", ""]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v, np.float32)
    return out


def _assert_trees_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg="/".join(k))


# ---------------------------------------------------------------- tokenizer


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("context_length", [32, 6])
@pytest.mark.parametrize("with_vocab", [True, False], ids=["vocab", "hash"])
def test_wordpiece_matches_jax(vocab_file, with_vocab, context_length):
    """[CLS] pieces [SEP] padded with a mask: whole words, greedy ``##``
    pieces, [UNK] for a word with no split, truncation that keeps [SEP],
    the empty text; with a vocab.txt and with the hash fallback."""
    path = vocab_file if with_vocab else None
    got = tokenizer.BertWordPieceTokenizer(path, context_length, 512)
    want = jax_tok.BertWordPieceTokenizer(path, context_length, 512)
    assert (got.vocab_size, got.cls_id, got.sep_id, got.pad_id, got.unk_id) == (
        want.vocab_size, want.cls_id, want.sep_id, want.pad_id, want.unk_id)
    ids, mask = got(TEXTS)
    want_ids, want_mask = want(TEXTS)
    assert ids.dtype == want_ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    if with_vocab and context_length == 32:
        v = {t: i for i, t in enumerate(VOCAB)}
        assert list(ids[4, :5]) == [v["[CLS]"], v["[UNK]"], v["speckle"], v["##s"], v["[SEP]"]]
    np.testing.assert_array_equal(got("speckle in OCT")[0], want("speckle in OCT")[0])


# ---------------------------------------------------------------- the BERT tower


def init_shapes(module, *args):
    """``module``'s parameter tree for ``args``, traced for shapes only
    (zeros): every leaf is then redrawn from a numpy seed."""
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(module.init, jax.random.key(0), *args))


def _jax_bert(seed=1, **kw):
    mod = jax_text.HFContextTextEncoder(**dict(TINY_BERT, **kw))
    ids = jnp.zeros((1, TINY_BERT["context_length"]), jnp.int32)
    params = init_shapes(mod, ids, jnp.ones_like(ids), jnp.zeros((3, 48)))
    return mod, randomize(params, np.random.default_rng(seed))


def _tokens(vocab_file):
    return jax_tok.BertWordPieceTokenizer(vocab_file, 32, 512)(TEXTS[:4])


@pytest.mark.parametrize("pooler", ["cls_last_hidden_state_pooler", "mean_pooler",
                                    "max_pooler"])
@pytest.mark.parametrize("n_ctx", [0, 3])
def test_bert_tower_matches_jax(vocab_file, pooler, n_ctx):
    """Padded prompts (mask zeros), with and without spliced context, each
    pooler: within 1e-5."""
    mod, params = _jax_bert(pooler_type=pooler)
    ids, mask = _tokens(vocab_file)
    assert (mask == 0).any()
    ctx = (np.random.default_rng(2).standard_normal((n_ctx, 48)).astype(np.float32)
           if n_ctx else None)
    want = mod.apply(params, ids, mask, ctx)
    port = load_flax_params(text_encoder.HFContextTextEncoder(**TINY_BERT, pooler_type=pooler),
                            params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _hf_state_dict(rng, hidden=48, layers=2, vocab=512, max_pos=40, type_rows=1):
    """A synthetic open_clip / HF BERT state dict (``text.`` prefix): a
    shorter position table and a single token-type row, as roberta ships."""
    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.2)

    P = "text.transformer."
    sd = {P + "embeddings.word_embeddings.weight": r(vocab, hidden),
          P + "embeddings.position_embeddings.weight": r(max_pos, hidden),
          P + "embeddings.token_type_embeddings.weight": r(type_rows, hidden),
          P + "embeddings.LayerNorm.weight": 1 + r(hidden),
          P + "embeddings.LayerNorm.bias": r(hidden),
          "text.proj.0.weight": r(32, hidden), "text.proj.2.weight": r(16, 32)}
    for i in range(layers):
        L = P + f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (hidden, hidden)),
                            ("attention.self.key", (hidden, hidden)),
                            ("attention.self.value", (hidden, hidden)),
                            ("attention.output.dense", (hidden, hidden)),
                            ("intermediate.dense", (4 * hidden, hidden)),
                            ("output.dense", (hidden, 4 * hidden))):
            sd[L + name + ".weight"] = r(*shape)
            sd[L + name + ".bias"] = r(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[L + name + ".weight"] = 1 + r(hidden)
            sd[L + name + ".bias"] = r(hidden)
    return sd


def test_bert_loader_matches_jax(vocab_file, tmp_path):
    """``load_torch_bert_weights`` on a synthetic state dict in a file: the
    same parameters as JAX's loader and the same tower outputs."""
    mod, params = _jax_bert()
    path = str(tmp_path / "bert.bin")
    torch.save(_hf_state_dict(np.random.default_rng(4)), path)
    want = jax_text.load_torch_bert_weights(params, path)
    port = text_encoder.load_torch_bert_weights(
        load_flax_params(text_encoder.HFContextTextEncoder(**TINY_BERT), params), path)
    _assert_trees_close(flax_params(port), want, 1e-6)
    ids, mask = _tokens(vocab_file)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(mod.apply(want, ids, mask)), rtol=0,
                               atol=1e-5)
    with pytest.raises(FileNotFoundError):
        text_encoder.load_torch_bert_weights(port, str(tmp_path / "missing.bin"))


# ---------------------------------------------------------------- the DDPM engine


ENGINE_KW = dict(use_image_context=True, tiny_text_encoder=True, CLIP_Type="BiomedCLIP")


@pytest.fixture(scope="module")
def jax_engine():
    with inits_shapes_only("CLIPDDPMEngine"):
        eng = JaxDDPMEngine(SETTINGS, sde=JaxDDPMSDE(T=T), image_size=RES, if_train=False,
                            **ENGINE_KW)
    rng = np.random.default_rng(0)
    for key in ("noise", "n_ema"):
        eng.state[key] = randomize(eng.state[key], rng)
    eng.text_params = randomize(eng.text_params, rng)
    return eng


@pytest.mark.parametrize("eta,sample_steps", [(1.0, None), (0.0, 2)],
                         ids=["eta1_T4", "eta0_strided2"])
def test_biomedclip_ddpm_sampler_matches_jax(jax_engine, eta, sample_steps):
    """The DDPM engine with the BERT tower (WordPiece ids and mask, 48-wide
    SMM context): within 1e-4 of JAX's ``build_sample_fn`` on JAX's noise."""
    eng = load_engine(CLIPDDPMEngine(SETTINGS, sde=DDPMSDE(T=T), device="cpu", **ENGINE_KW),
                      jax_engine.state, jax_engine.text_params)
    np.testing.assert_array_equal(eng.prompt_ids.numpy(), np.asarray(jax_engine.prompt_ids))
    np.testing.assert_array_equal(eng.prompt_mask.numpy(), np.asarray(jax_engine.prompt_mask))
    assert eng.token_embed_dim == 48
    rng = np.random.default_rng(1)
    mu = rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32)
    type_idx = np.array([2, 0], np.int32)
    emb = rng.standard_normal((B, 1, 16)).astype(np.float32)
    key = jax.random.key(7)
    sample = jax.jit(jax_engine.build_sample_fn(sample_steps=sample_steps, eta=eta))
    want = np.asarray(sample(jax_engine.state["n_ema"], jax_engine.text_params, mu, type_idx,
                             emb, key))
    n_steps = T if sample_steps is None else sample_steps
    eps, zs = _jax_noise(key, mu.shape, n_steps)
    got = eng.test({"input": mu, "type_idx": type_idx, "A_emb": emb}, sample_steps=sample_steps,
                   eta=eta, init_noise=torch.tensor(eps), step_noise=[torch.tensor(z) for z in zs])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_biomedclip_pretrain_path_loads_the_bert_checkpoint(jax_engine, tmp_path):
    """``text_encoder_pretrain_path`` with ``CLIP_Type: BiomedCLIP`` reads a
    BERT state dict through ``load_torch_bert_weights``, as the JAX
    engines' ``_maybe_load_text_pretrain`` does."""
    path = str(tmp_path / "biomedclip.bin")
    torch.save(_hf_state_dict(np.random.default_rng(5), max_pos=64, type_rows=2), path)
    eng = CLIPDDPMEngine(SETTINGS, sde=DDPMSDE(T=T), device="cpu",
                         text_encoder_pretrain_path=path, **ENGINE_KW)
    assert eng.text_weights == "pretrained"
    want = jax_text.load_torch_bert_weights(jax_engine.text_params, path)
    _assert_trees_close(flax_params(eng.text_encoder), want, 0)


@pytest.mark.parametrize("engine", ["drift", "ddpm"])
def test_biomedclip_engines_take_a_train_step(engine):
    """Both engines train with the BERT tower: a finite loss, and the SMM
    contexts (reached only through the frozen tower) move."""
    kw = dict(device="cpu", if_train=True, image_size=RES, **ENGINE_KW)
    if engine == "drift":
        eng = CLIPDriftEngine(SETTINGS, SETTINGS, score_map_ch_mult=(1, 1), score_map_ngf=8,
                              sde=DriftSDE(T=T, max_sigma=0.4), **kw)
    else:
        eng = CLIPDDPMEngine(SETTINGS, sde=DDPMSDE(T=T), **kw)
    rng = np.random.default_rng(3)
    batch = {"input": rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
             "target": rng.uniform(-1, 1, (B, RES, RES, 1)).astype(np.float32),
             "type_idx": np.array([1, 3]), "A_emb": rng.standard_normal((B, 1, 16))
             .astype(np.float32)}
    net = eng.nets["noise"]
    before = [c.detach().clone() for c in net.smm_contexts()]
    loss = eng.optimize_parameters(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(loss)
    assert all(not torch.equal(a, b) for a, b in zip(before, net.smm_contexts()))


# ---------------------------------------------------------------- BiomedCLIP


@pytest.fixture(scope="module")
def jax_model():
    """JAX's tiny ``get_BiomedCLIP``, both towers' leaves redrawn (their
    inits traced for shapes only, which also stubs the jitted image encoder:
    jitted again here)."""
    with inits_shapes_only("BiomedCLIP"):
        model = jax_biomedclip.get_BiomedCLIP(tiny=True)
    model._encode_image = jax.jit(lambda p, x: model.visual.apply(p, x))
    rng = np.random.default_rng(6)
    model.visual_params = randomize(jax.tree.map(np.asarray, model.visual_params), rng)
    model.text_params = randomize(jax.tree.map(np.asarray, model.text_params), rng)
    return model


def test_biomedclip_matches_jax(jax_model, vocab_file):
    """``encode_image`` / ``encode_text`` (L2-normalised) and the logits,
    from the JAX towers' trees: within 1e-5."""
    model = biomedclip.get_BiomedCLIP(vocab_path=vocab_file, tiny=True,
                                      params=jax_model.visual_params,
                                      text_params=jax_model.text_params, device="cpu")
    jax_model.tokenizer = jax_tok.BertWordPieceTokenizer(vocab_file, 32, 512)
    images = np.random.default_rng(7).uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    for got, want in ((model.encode_image(images), jax_model.encode_image(images)),
                      (model.encode_text(TEXTS[:4]), jax_model.encode_text(TEXTS[:4])),
                      (model(images, TEXTS[:4]), jax_model(images, TEXTS[:4]))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", ["bf16", "pure_bf16", "fp16", "pure_fp16"])
def test_biomedclip_low_precision_matches_jax(jax_model, vocab_file, precision):
    """``precision`` bf16 / fp16 (16-bit compute, float32 parameters) and
    pure_bf16 / pure_fp16 (the parameters cast too): ``encode_image`` and
    ``encode_text`` within 1e-2 of JAX's model at that precision (XLA's CPU
    fp16 against the port's, whose CPU attention is the float32 plain
    version), from the same trees; both within 1e-2 of JAX's fp32 model."""
    low = jnp.bfloat16 if "bf16" in precision else jnp.float16
    with inits_shapes_only("BiomedCLIP"):
        want = jax_biomedclip.get_BiomedCLIP(tiny=True, precision=precision)
    want._encode_image = jax.jit(lambda p, x: want.visual.apply(p, x))
    want.tokenizer = jax_tok.BertWordPieceTokenizer(vocab_file, 32, 512)
    jax_model.tokenizer = want.tokenizer
    cast = (lambda t: jax.tree.map(lambda x: jnp.asarray(x, low), t)) \
        if precision.startswith("pure_") else (lambda t: t)
    want.visual_params, want.text_params = (cast(jax_model.visual_params),
                                            cast(jax_model.text_params))
    model = biomedclip.get_BiomedCLIP(vocab_path=vocab_file, tiny=True, precision=precision,
                                      params=jax_model.visual_params,
                                      text_params=jax_model.text_params, device="cpu")
    images = np.random.default_rng(8).uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    fp32 = (jax_model.encode_image(images), jax_model.encode_text(TEXTS[:4]))
    for got, ref, full in ((model.encode_image(images), want.encode_image(images), fp32[0]),
                           (model.encode_text(TEXTS[:4]), want.encode_text(TEXTS[:4]), fp32[1])):
        assert got.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}[low]
        assert np.asarray(ref).dtype == low
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                                   atol=1e-2)
        for side in (got.float().numpy(), np.asarray(ref, np.float32)):
            np.testing.assert_allclose(side, np.asarray(full), rtol=0, atol=1e-2)


def test_biomedclip_precision_strings_match_jax():
    for p in biomedclip.PRECISIONS + (None,):
        got = biomedclip._precision_dtypes(p)
        want = jax_biomedclip._precision_dtypes(p)
        assert [None if g is None else str(g).split(".")[-1] for g in got] == \
            [None if w is None else jnp.dtype(w).name for w in want]
        assert str(biomedclip.get_input_dtype(p)).split(".")[-1] == \
            str(None if jax_biomedclip.get_input_dtype(p) is None
                else jnp.dtype(jax_biomedclip.get_input_dtype(p)).name)
        cast = biomedclip.get_cast_dtype(p)
        jcast = jax_biomedclip.get_cast_dtype(p)
        assert (cast is None) == (jcast is None)
    with pytest.raises(ValueError, match="unknown precision"):
        biomedclip._precision_dtypes("fp8")


def test_biomedclip_refuses_what_it_cannot_do(jax_model):
    """The refusals that stand: no weights (the port draws none), a text
    tower no weights reached, an unknown tower or flavour. (The RN tower
    and fp16 run: ``test_biomedclip_resnet_and_clip_match_jax``,
    ``test_biomedclip_low_precision_matches_jax``.)"""
    with pytest.raises(ValueError, match="draws none"):
        biomedclip.get_BiomedCLIP(tiny=True, device="cpu")
    model = biomedclip.get_BiomedCLIP(tiny=True, device="cpu", params=jax_model.visual_params)
    with pytest.raises(ValueError, match="text tower has no weights"):
        model.encode_text(["speckle in OCT"])
    with pytest.raises(ValueError, match="unknown vision_tower"):
        biomedclip.BiomedCLIP(vision_tower="convnext", tiny=True, device="cpu",
                              params=jax_model.visual_params)
    with pytest.raises(ValueError, match="unknown clip_type"):
        biomedclip.BiomedCLIP(clip_type="SigLIP", tiny=True, device="cpu",
                              params=jax_model.visual_params)


@pytest.mark.parametrize("clip_type,vision_tower", [("BiomedCLIP", "resnet"), ("CLIP", "vit"),
                                                    ("CLIP", "resnet")])
def test_biomedclip_resnet_and_clip_match_jax(clip_type, vision_tower):
    """``vision_tower="resnet"`` (the RN family's ``ModifiedResNet``, width
    8, its attention pool's heads of 64) and ``clip_type="CLIP"`` (the
    OpenAI ViT, the CLIP text tower, the BPE tokenizer's hash fallback):
    ``encode_image``, ``encode_text`` and the logits within 1e-5 of JAX's
    tiny model from the same trees."""
    with inits_shapes_only("BiomedCLIP"):
        want = jax_biomedclip.BiomedCLIP(clip_type=clip_type, vision_tower=vision_tower,
                                         tiny=True)
    want._encode_image = jax.jit(lambda p, x: want.visual.apply(p, x))
    rng = np.random.default_rng(9)
    # BatchNorm variances (zeros from the shapes-only init) kept positive
    want.visual_params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.abs(v) + 0.5 if path[-1].key == "var" else v,
        randomize(jax.tree.map(np.asarray, want.visual_params), rng))
    want.text_params = randomize(jax.tree.map(np.asarray, want.text_params), rng)
    model = biomedclip.BiomedCLIP(clip_type=clip_type, vision_tower=vision_tower, tiny=True,
                                  params=want.visual_params, text_params=want.text_params,
                                  device="cpu")
    assert type(model.visual).__name__ == ("ModifiedResNet" if vision_tower == "resnet"
                                           else "CLIPVisionTower")
    texts = ["speckle in OCT", "noise in cryo-EM image", "low dose CT"]
    images = np.random.default_rng(10).uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32)
    for got, ref in ((model.encode_image(images), want.encode_image(images)),
                     (model.encode_text(texts), want.encode_text(texts)),
                     (model(images, texts), want(images, texts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(np.asarray(ref)).max()))


def test_precompute_embeddings_matches_jax(jax_model, tmp_path, monkeypatch):
    """The port's tool (``--params`` from ``tools/export_image_params.py
    --biomedclip --tiny``, which writes JAX's text tower too with
    ``--text-out``) against JAX's tool on copies of one index, 32 px: every
    ``_emb.raw`` within 1e-5, the same index."""
    from tools import export_image_params
    from tools import precompute_embeddings as jax_tool

    monkeypatch.setattr(jax_biomedclip, "get_BiomedCLIP", lambda **kw: jax_model)
    params, text = str(tmp_path / "visual.ckpt"), str(tmp_path / "text.ckpt")
    assert export_image_params.main(["--biomedclip", "--tiny", "--out", params,
                                     "--text-out", text]) == params
    _assert_trees_close(load_pytree(text), jax_model.text_params, 0)
    names = ("scatter artifact in CT", "noise in cryo-EM image", "speckle in OCT")
    roots = {}
    for side in ("jax", "port"):
        roots[side] = chip_smoke.write_speckle_med(str(tmp_path / side), 2, 32, 16, names)
    monkeypatch.setattr("sys.argv", ["precompute_embeddings.py", "--index", roots["jax"],
                                     "--res", "32", "--tiny"])
    jax_tool.main()
    n = precompute_embeddings.main(["--index", roots["port"], "--res", "32", "--tiny",
                                    "--params", params, "--batch", "4", "--device", "cpu"])
    want, got = (json.load(open(roots[s])) for s in ("jax", "port"))
    assert n == sum(len(v) for v in got.values()) == 18
    for split in want:
        for w, g in zip(want[split], got[split]):
            assert os.path.relpath(g["A_emb"], tmp_path / "port") == \
                os.path.relpath(w["A_emb"], tmp_path / "jax")
            np.testing.assert_allclose(np.fromfile(g["A_emb"], np.float32),
                                       np.fromfile(w["A_emb"], np.float32), rtol=0, atol=1e-5)
