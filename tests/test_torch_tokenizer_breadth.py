"""The port's tokenizer breadth against the JAX package's tokenizers on the
CPU: the text-cleaning functions, ``ClipBPETokenizer``'s decode, clean,
reduction-mask and special-token options on a tiny merges file the test
writes, the three reduction-mask tokenizers with the same numpy seed, and
``SigLipTokenizer``'s offline fallback. Host code only: ids are compared
exactly."""

import gzip
import os

import numpy as np
import pytest

from instancediff_tpu.models import tokenizer as jtok

from instancediff_torch.models import tokenizer as tok

from test_torch_engine import one_torch_thread  # noqa: F401  (autouse)

CORPUS = [
    "Speckle in OCT",
    "  noise   in\tcryo-EM image!! ",
    "Gaussian_noise in MRI; low-dose CT (scatter) &amp;amp; more",
    "It's a 3D volume -- don't over-smooth: keep edges.",
    "A_b_c. d,e;f? 'quoted' \"double\" [brackets] {braces}",
    "Ünïcödé tèxt with &lt;tags&gt; and émojis ✓",
    "",
]
# long enough to be cut at context 8: the reduction masks then drop tokens
LONG = ["the speckled retinal layers in a noisy optical coherence tomography scan of the eye",
        "denoised images preserve fine anatomical structures and edges"]
MERGES = ["s p", "e c", "k l", "l e</w>", "sp ec", "spec kl", "n o", "i s", "no is",
          "i n</w>", "o c", "m r"]


@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "tiny_merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return str(path)


@pytest.mark.parametrize("text", CORPUS)
def test_cleaning_matches_jax(text):
    for name in ("canonicalize", "lower", "whitespace"):
        assert tok.get_clean_fn(name)(text) == jtok.get_clean_fn(name)(text)
    assert tok.canonicalize_text(text) == jtok.canonicalize_text(text)
    for keep in ("--", "'s", "_"):
        assert (tok.canonicalize_text(text, keep_punctuation_exact_string=keep)
                == jtok.canonicalize_text(text, keep_punctuation_exact_string=keep))


def test_clean_and_mask_registries():
    with pytest.raises(AssertionError):
        tok.get_clean_fn("upper")
    with pytest.raises(AssertionError):
        jtok.get_clean_fn("upper")
    assert tok.get_reduction_mask_fn("simple") is tok.simple_mask_tokenize
    assert tok.get_reduction_mask_fn("random") is tok.random_mask_tokenize
    assert tok.get_reduction_mask_fn("syntax") is tok.syntax_mask_tokenize
    shuffle = tok.get_reduction_mask_fn("shuffle")
    assert shuffle.func is tok.random_mask_tokenize and shuffle.keywords == {"shuffle": True}
    with pytest.raises(AssertionError):
        tok.get_reduction_mask_fn("drop")
    with pytest.raises(AssertionError):
        jtok.get_reduction_mask_fn("drop")


def test_bpe_encode_decode_round_trip(merges_file):
    """The tiny merges file: ids equal JAX's, ``decode`` equals JAX's and
    gives back the cleaned words, each closed by a space."""
    port = tok.ClipBPETokenizer(merges_file, context_length=24)
    ref = jtok.ClipBPETokenizer(merges_file, context_length=24)
    assert port.vocab_size == ref.vocab_size == 2 * 256 + len(MERGES) + 2
    for text in CORPUS[:4] + ["Speckle noise in OCT"]:
        ids = port.encode(text)
        assert ids == ref.encode(text)
        assert port.decode(ids) == ref.decode(ids)
        words = port._pat.findall(port.clean_fn(text))
        assert port.decode(ids) == "".join(w + " " for w in words)
    np.testing.assert_array_equal(port(CORPUS), ref(CORPUS))
    with pytest.raises(ValueError, match="real BPE vocab"):
        tok.ClipBPETokenizer().decode([1, 2])


@pytest.mark.parametrize("clean", ["canonicalize", "lower", "whitespace"])
def test_bpe_clean_option(merges_file, clean):
    port = tok.ClipBPETokenizer(merges_file, clean=clean)
    ref = jtok.ClipBPETokenizer(merges_file, clean=clean)
    np.testing.assert_array_equal(port(CORPUS), ref(CORPUS))
    np.testing.assert_array_equal(tok.ClipBPETokenizer(clean=clean)(CORPUS),
                                  jtok.ClipBPETokenizer(clean=clean)(CORPUS))


def test_bpe_additional_special_tokens(merges_file):
    extra = ["<mask>", "<sep>"]
    port = tok.ClipBPETokenizer(merges_file, additional_special_tokens=extra)
    ref = jtok.ClipBPETokenizer(merges_file, additional_special_tokens=extra)
    texts = ["<mask> speckle <sep> in OCT", "no special tokens"]
    np.testing.assert_array_equal(port(texts), ref(texts))
    assert port.encoder["<mask>"] == port.vocab_size - 2 and port.sot_id == port.vocab_size - 4
    assert port.encode("<mask>") == [port.encoder["<mask>"]]


def _encode(text):
    return jtok.ClipBPETokenizer().encode(text)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("context_length", [8, 40])
def test_random_and_simple_masks_match_jax(seed, context_length):
    """The same ``np.random.default_rng(seed)`` gives JAX's ids; texts that
    fit are not cut."""
    texts = LONG + CORPUS[:2]
    for name, kw in (("random", {}), ("random", {"shuffle": True}), ("simple", {})):
        got = getattr(tok, f"{name}_mask_tokenize")(
            texts, context_length, 49406, 49407, _encode, rng=np.random.default_rng(seed), **kw)
        want = getattr(jtok, f"{name}_mask_tokenize")(
            texts, context_length, 49406, 49407, _encode, rng=np.random.default_rng(seed), **kw)
        assert got.dtype == np.int32 and got.shape == (len(texts), context_length)
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] == 49406).all() and ((got == 49407).sum(axis=1) == 1).all()


@pytest.mark.parametrize("context_length", [5, 8, 40])
def test_syntax_mask_matches_jax(context_length):
    """The default tagger (nltk with its data, else the suffix heuristic) and
    an injected one."""
    texts = LONG + CORPUS[:3]
    for tagger in (None, lambda t: [(w, "VB" if i % 2 else "NN")
                                    for i, w in enumerate(t.split())]):
        got = tok.syntax_mask_tokenize(texts, context_length, 1, 2, _encode, tagger=tagger)
        want = jtok.syntax_mask_tokenize(texts, context_length, 1, 2, _encode, tagger=tagger)
        np.testing.assert_array_equal(got, want)
    assert tok._default_tagger(LONG[0]) == jtok._default_tagger(LONG[0])
    assert tok._heuristic_pos_tag(LONG[1]) == jtok._heuristic_pos_tag(LONG[1])
    # nouns first: with room for one word, the injected tagger's first noun
    tagged = tok.syntax_mask_tokenize(["quickly running dog"], 3, 1, 2, _encode,
                                      tagger=lambda t: [("quickly", "RB"), ("running", "VBG"),
                                                        ("dog", "NN")])
    assert tagged[0].tolist() == [1] + _encode("dog") + [2]


@pytest.mark.parametrize("mask", ["simple", "random", "shuffle", "syntax"])
def test_bpe_reduction_mask_wiring(merges_file, monkeypatch, mask):
    """``ClipBPETokenizer(reduction_mask=...)`` drops tokens with the named
    mask (the unseeded generator of both seeded alike here)."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a: real(3))
    port = tok.ClipBPETokenizer(merges_file, context_length=8, reduction_mask=mask)
    ref = jtok.ClipBPETokenizer(merges_file, context_length=8, reduction_mask=mask)
    got = port(LONG)
    np.testing.assert_array_equal(got, ref(LONG))
    assert got.shape == (2, 8) and (got[:, 0] == port.sot_id).all()
    # without a mask the text's end is cut; a mask keeps other tokens
    plain = tok.ClipBPETokenizer(merges_file, context_length=8)(LONG)
    assert (plain[:, -1] == port.eot_id).all() and not np.array_equal(got, plain)


def test_siglip_fallback_matches_jax(tmp_path):
    for context_length in (None, 6):
        got = tok.SigLipTokenizer()(CORPUS, context_length=context_length)
        want = jtok.SigLipTokenizer()(CORPUS, context_length=context_length)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    missing = str(tmp_path / "no_such_spiece.model")
    port = tok.SigLipTokenizer(missing, context_length=16)
    assert port.tokenizer is None
    np.testing.assert_array_equal(port(LONG), jtok.SigLipTokenizer(missing, 16)(LONG))
    ids = port("Speckle, in OCT!")[0]
    assert ids[3] == port.eos_id == 1 and (ids[4:] == port.pad_id).all()


# ------------------------------------------------- the reference's vocab files

# WordPiece pieces of the five artifact prompts, after the four specials
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "speck", "##le", "in", "oct", "ultra", "sound",
         "noise", "cry", "##o", "-", "em", "image", "low", "dose", "ct", "gaussian", "mri"]
LAYOUTS = {"top": "", "nested": "BiomedCLIP", "absent": None}


@pytest.fixture(params=LAYOUTS, ids=LAYOUTS.keys())
def asset_dir(request, tmp_path, monkeypatch):
    """Both packages' ``_REFERENCE_ASSET_DIR`` pointed at ``tmp_path``, with
    a small ``vocab.txt`` and BPE merges file at its top level, in its
    ``BiomedCLIP/`` subdirectory, or absent. Checks afterwards that the
    real directory was not written."""
    real = tok._REFERENCE_ASSET_DIR, jtok._REFERENCE_ASSET_DIR
    existed = [os.path.exists(d) for d in real]
    sub = LAYOUTS[request.param]
    if sub is not None:
        (tmp_path / sub).mkdir(exist_ok=True)
        (tmp_path / sub / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
        with gzip.open(tmp_path / sub / "bpe_simple_vocab_16e6.txt.gz", "wt",
                       encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setattr(tok, "_REFERENCE_ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(jtok, "_REFERENCE_ASSET_DIR", str(tmp_path))
    yield request.param
    assert [os.path.exists(d) for d in real] == existed


def test_reference_asset_dir_is_jax_s():
    """Unpatched, the port looks where the JAX package looks, whatever the
    caller's home directory is."""
    assert tok._REFERENCE_ASSET_DIR == jtok._REFERENCE_ASSET_DIR


def test_default_vocab_path_matches_jax(asset_dir):
    for kind in ("bert", "bpe"):
        got = tok.default_vocab_path(kind)
        assert got == jtok.default_vocab_path(kind)
        assert (got is None) == (asset_dir == "absent")


def _engine(clip_type, tiny):
    """A drift engine with the tiny UNet and the ``clip_type`` text tower
    (full width unless ``tiny``), its vocab found by itself."""
    from instancediff_torch.models.drift_model import CLIPDriftEngine

    settings = dict(in_nc=2, out_nc=5, nf=8, ch_mult=[1], context_dim=16, score_map_chan=4,
                    num_res_blocks=1)
    return CLIPDriftEngine(settings, settings, score_map_ch_mult=(1,), score_map_ngf=8,
                           CLIP_Type=clip_type, tiny_text_encoder=tiny, device="cpu")


@pytest.mark.parametrize("asset_dir", ["nested"], indirect=True)
@pytest.mark.parametrize("clip_type", ["BiomedCLIP", "CLIP"])
def test_engine_prompt_ids_from_the_reference_vocab(asset_dir, clip_type):
    """A full-width tower's engine tokenises the five prompts with the
    reference's file where JAX's engine finds one (``default_vocab_path``,
    here in the nested directory, where the BPE file ships), to the JAX
    tokenizer's ids from that file; a tiny tower still hashes."""
    from instancediff_torch.models.engine import ARTIFACT_PROMPTS

    prompts = list(ARTIFACT_PROMPTS)
    for tiny in (False, True):
        eng = _engine(clip_type, tiny)
        text = eng.text_encoder
        kind = "bert" if clip_type == "BiomedCLIP" else "bpe"
        path = None if tiny else jtok.default_vocab_path(kind)
        assert (path is None) == tiny
        if kind == "bert":
            ids, mask = jtok.BertWordPieceTokenizer(path, context_length=text.context_length,
                                                    vocab_size=text.vocab_size)(prompts)
            np.testing.assert_array_equal(eng.prompt_mask.numpy(), mask)
        else:
            ids = jtok.ClipBPETokenizer(path, context_length=text.context_length,
                                        vocab_size=text.vocab_size)(prompts)
        np.testing.assert_array_equal(eng.prompt_ids.numpy(), ids)


def test_get_biomedclip_reads_only_the_fixed_vocab_file(asset_dir):
    """``get_BiomedCLIP`` follows JAX's rule for that loader: the one file
    ``<asset dir>/vocab.txt``, tiny or not, no subdirectory lookup."""
    from instancediff_torch.models.biomedclip import get_BiomedCLIP
    from instancediff_torch.models.clip_vit import CLIPVisionTower
    from instancediff_torch.models.engine import ARTIFACT_PROMPTS
    from instancediff_torch.utils.convert import flax_params

    visual = flax_params(CLIPVisionTower(embed_dim=512, flavour="timm", image_size=32,
                                         patch_size=8, width=32, layers=2, heads=4))
    model = get_BiomedCLIP(tiny=True, params=visual, device="cpu")
    path = jtok.default_vocab_path("bert") if asset_dir == "top" else None
    want = jtok.BertWordPieceTokenizer(path, context_length=32, vocab_size=512)
    for got, w in zip(model.tokenizer(list(ARTIFACT_PROMPTS)), want(list(ARTIFACT_PROMPTS))):
        np.testing.assert_array_equal(got, w)
