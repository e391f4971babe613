"""The port's tokenizer breadth against the JAX package's tokenizers on the
CPU: the text-cleaning functions, ``ClipBPETokenizer``'s decode, clean,
reduction-mask and special-token options on a tiny merges file the test
writes, the three reduction-mask tokenizers with the same numpy seed, and
``SigLipTokenizer``'s offline fallback. Host code only: ids are compared
exactly."""

import gzip

import numpy as np
import pytest

from instancediff_tpu.models import tokenizer as jtok

from instancediff_torch.models import tokenizer as tok

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
