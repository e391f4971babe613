"""Host-side tokenizers (copy of ``ClipBPETokenizer``,
``BertWordPieceTokenizer``, ``SigLipTokenizer``, the text-cleaning functions
and the reduction-mask tokenizers of ``instancediff_tpu/models/tokenizer.py``).

With a BPE merges file ``ClipBPETokenizer`` splits and byte-pair-encodes as
CLIP's SimpleTokenizer does; with a ``vocab.txt`` ``BertWordPieceTokenizer``
splits words into greedy longest-match WordPiece pieces. Without the file,
a deterministic hash of each word gives stable ids, the same ids as the JAX
package's fallback. The reduction-mask tokenizers draw from an explicit
``np.random.Generator``, so one seed gives JAX's ids."""

from __future__ import annotations

import gzip
import hashlib
import html
import os
import re
import string
from functools import partial

import numpy as np

try:  # mojibake repair when installed; identity otherwise (as in the JAX package)
    import ftfy as _ftfy

    _fix_text = _ftfy.fix_text
except ImportError:  # pragma: no cover - environment-dependent
    def _fix_text(s: str) -> str:
        return s


def basic_clean(text: str) -> str:
    """ftfy fix + double html-unescape + strip."""
    text = _fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize_text(text: str, *, keep_punctuation_exact_string: str | None = None) -> str:
    """Lowercase, punctuation removed, whitespace collapsed (big_vision's
    prompt canonicalisation). ``keep_punctuation_exact_string`` keeps exact
    occurrences of that string while its characters elsewhere are removed."""
    text = text.replace("_", " ")
    strip_punct = str.maketrans("", "", string.punctuation)
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(strip_punct)
            for part in text.split(keep_punctuation_exact_string))
    else:
        text = text.translate(strip_punct)
    return re.sub(r"\s+", " ", text.lower()).strip()


def _clean_canonicalize(x: str) -> str:
    return canonicalize_text(basic_clean(x))


def _clean_lower(x: str) -> str:
    return whitespace_clean(basic_clean(x)).lower()


def _clean_whitespace(x: str) -> str:
    return whitespace_clean(basic_clean(x))


_CLEAN_FNS = {"canonicalize": _clean_canonicalize, "lower": _clean_lower,
              "whitespace": _clean_whitespace}


def get_clean_fn(type: str):
    """The text-cleaning function named ``type``: canonicalize, lower or
    whitespace."""
    if type not in _CLEAN_FNS:
        raise AssertionError(f"Invalid clean function ({type}).")
    return _CLEAN_FNS[type]


def random_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn, shuffle: bool = False,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """<sot> tokens <eot>, zero-padded; a text with more than
    ``context_length - 2`` tokens keeps a random subset of that many, in
    their order (``shuffle``: in the drawn order)."""
    rng = rng or np.random.default_rng()
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = np.asarray(encode_fn(text), dtype=np.int32)
        num_tokens = len(tokens)
        if num_tokens > context_length - 2:  # 2 slots for sot and eot
            num_keep = context_length - 2
            indices = rng.permutation(num_tokens)[:num_keep]
            if not shuffle:
                indices = np.sort(indices)
            tokens = tokens[indices]
            num_tokens = num_keep
        result[i, 0] = sot_token_id
        result[i, 1:num_tokens + 1] = tokens
        result[i, num_tokens + 1] = eot_token_id
    return result


def simple_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """<sot> tokens <eot>, zero-padded; a text with more than
    ``context_length - 2`` tokens keeps one random contiguous block of that
    many."""
    rng = rng or np.random.default_rng()
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = list(encode_fn(text))
        num_tokens = len(tokens)
        if num_tokens > context_length - 2:
            num_keep = context_length - 2
            start = int(rng.integers(0, num_tokens - num_keep + 1))
            tokens = tokens[start:start + num_keep]
        tokens = [sot_token_id] + tokens + [eot_token_id]
        result[i, :len(tokens)] = tokens
    return result


# (suffix, tag) rules of the offline tagger: enough to keep the noun >
# adjective > verb priority on the prompts
_POS_SUFFIX_RULES = (
    ("ing", "VBG"), ("ed", "VBD"), ("ly", "RB"), ("ous", "JJ"), ("ful", "JJ"),
    ("ive", "JJ"), ("able", "JJ"), ("al", "JJ"), ("ian", "JJ"),
)


def _heuristic_pos_tag(text: str):
    """[(word, tag)] by suffix rules and a closed-class word list, NN by
    default: the offline stand-in for ``nltk.pos_tag(word_tokenize(text))``."""
    closed = {"in", "of", "the", "a", "an", "and", "or", "with", "on", "to",
              "is", "are", "was", "were", "at", "by", "for", "from"}
    out = []
    for tok in text.split():
        low = tok.lower()
        if low in closed:
            out.append((tok, "IN"))
            continue
        for suf, tag in _POS_SUFFIX_RULES:
            if low.endswith(suf) and len(low) > len(suf) + 1:
                out.append((tok, tag))
                break
        else:
            out.append((tok, "NN"))
    return out


def _default_tagger(text: str):
    """nltk's tokenizer and tagger when nltk and its data are installed, else
    ``_heuristic_pos_tag``."""
    try:
        import nltk

        return nltk.pos_tag(nltk.tokenize.word_tokenize(text))
    except (ImportError, LookupError):
        return _heuristic_pos_tag(text)


def syntax_mask_tokenize(texts, context_length: int, sot_token_id: int,
                         eot_token_id: int, encode_fn, tagger=None) -> np.ndarray:
    """<sot> tokens <eot>, zero-padded, after dropping words by part of speech
    to ``context_length - 2``: nouns kept first, then adjectives, then verbs,
    then the rest (a stable order within each). ``tagger`` maps a text to
    ``[(word, tag), ...]`` (default ``_default_tagger``). A text whose kept
    words encode to too many tokens is cut and closed with <eot>."""
    tagger = tagger or _default_tagger
    if isinstance(texts, str):
        texts = [texts]

    def get_order(tag: str) -> int:
        if tag.startswith("NN"):
            return 1
        if tag.startswith("JJ"):
            return 2
        if tag.startswith("VB"):
            return 3
        return 4

    new_texts = []
    for text in texts:
        tagged = tagger(text)
        order = np.array([get_order(tag) for _, tag in tagged])
        sorted_ids = np.argsort(order)
        sampled_ids = sorted(sorted_ids[:context_length - 2])
        new_texts.append(" ".join(tagged[j][0] for j in sampled_ids))

    result = np.zeros((len(new_texts), context_length), dtype=np.int32)
    for i, text in enumerate(new_texts):
        tokens = [sot_token_id] + list(encode_fn(text)) + [eot_token_id]
        if len(tokens) > context_length:  # a word may encode to several tokens
            tokens = tokens[:context_length]
            tokens[-1] = eot_token_id
        result[i, :len(tokens)] = tokens
    return result


def get_reduction_mask_fn(type: str):
    """The reduction-mask tokenizer named ``type``: simple (one contiguous
    block), random (a random subset in order), shuffle (a random subset in
    the drawn order) or syntax (by part of speech)."""
    if type == "simple":
        return simple_mask_tokenize
    if type == "random":
        return random_mask_tokenize
    if type == "shuffle":
        return partial(random_mask_tokenize, shuffle=True)
    if type == "syntax":
        return syntax_mask_tokenize
    raise AssertionError(f"Invalid reduction mask ({type}).")


def _hash_id(token: str, vocab_size: int, reserved: int = 10) -> int:
    h = int.from_bytes(hashlib.sha256(token.encode()).digest()[:4], "little")
    return reserved + (h % (vocab_size - reserved))


_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")

# Where the reference implementation's tokenizer data lies: the JAX
# package's fixed directory, ``reference/models/BiomedCLIP`` in the root
# user's home whoever runs (so both packages find the same files),
# ``vocab.txt`` for WordPiece and ``bpe_simple_vocab_16e6.txt.gz`` for CLIP's
# BPE, the latter in the nested package directory. Only read.
_REFERENCE_ASSET_DIR = os.path.join(os.path.expanduser("~root"), "reference", "models",
                                    "BiomedCLIP")


def default_vocab_path(kind: str) -> str | None:
    """The reference's vocab file for tokenizer ``kind`` ("bert":
    ``vocab.txt``, else the BPE merges), looked up in ``_REFERENCE_ASSET_DIR``
    and then in its ``BiomedCLIP/`` subdirectory; None when absent (the
    tokenizers then hash)."""
    name = "vocab.txt" if kind == "bert" else "bpe_simple_vocab_16e6.txt.gz"
    for sub in ("", "BiomedCLIP"):
        cand = os.path.join(_REFERENCE_ASSET_DIR, sub, name)
        if os.path.isfile(cand):
            return cand
    return None


def _basic_tokenize(text: str):
    return _WORD_RE.findall(text.lower())


class BertWordPieceTokenizer:
    """WordPiece with BERT's special tokens: [CLS] pieces [SEP], padded with
    [PAD] to ``context_length``, with a 0/1 mask. Pieces after a word's
    first are looked up as ``##piece``; a word with no split into known
    pieces is one [UNK]; the text is cut so that [SEP] stays. ``vocab_path``
    is a ``vocab.txt`` (one token per line); None selects the hash fallback
    (pad 0, unk 1, cls 2, sep 3, words hashed to ``[10, vocab_size)``).
    ``__call__(texts) -> (ids, mask)``, int32 [K, context_length] each."""

    def __init__(self, vocab_path: str | None = None, context_length: int = 256,
                 vocab_size: int = 30522):
        self.context_length = context_length
        self.vocab = None
        self.vocab_size = vocab_size
        if vocab_path and os.path.isfile(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
            self.vocab_size = len(self.vocab)
            self.cls_id = self.vocab.get("[CLS]", 2)
            self.sep_id = self.vocab.get("[SEP]", 3)
            self.pad_id = self.vocab.get("[PAD]", 0)
            self.unk_id = self.vocab.get("[UNK]", 1)
        else:
            self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3

    def _wordpiece(self, word: str):
        if self.vocab is None:
            return [_hash_id(word, self.vocab_size)]
        if word in self.vocab:
            return [self.vocab[word]]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def __call__(self, texts):
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.cls_id]
            for w in _basic_tokenize(text):
                ids.extend(self._wordpiece(w))
            ids = ids[: self.context_length - 1] + [self.sep_id]
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return out, mask


def _clip_word_pattern(special_tokens):
    """CLIP's pre-tokenizer split pattern; needs ``regex`` for \\p classes,
    None when it is missing (``_WORD_RE`` then applies)."""
    try:
        import regex
    except ImportError:  # pragma: no cover - environment-dependent
        return None
    special = "|".join(re.escape(t) for t in special_tokens)
    return regex.compile(
        special + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        regex.IGNORECASE,
    )


def _bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ClipBPETokenizer:
    """CLIP byte-pair tokenizer: <SOT> bpe(text) <EOT>, zero-padded to
    ``context_length``. ``bpe_path`` is the gzip merges file; None selects
    the hash fallback (sot = vocab_size-2, eot = vocab_size-1). ``clean``
    names the text-cleaning function (``get_clean_fn``); ``reduction_mask``
    (``get_reduction_mask_fn``'s names; "" for none) drops tokens to fit the
    context instead of cutting the text's end; ``additional_special_tokens``
    are encoded whole, after <SOT> and <EOT> in the vocabulary."""

    def __init__(self, bpe_path: str | None = None, context_length: int = 42,
                 vocab_size: int = 49408, clean: str = "lower", reduction_mask: str = "",
                 additional_special_tokens: list[str] | None = None):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.encoder = None
        self.clean_fn = get_clean_fn(clean)
        self.reduction_fn = get_reduction_mask_fn(reduction_mask) if reduction_mask else None
        special_tokens = ["<start_of_text>", "<end_of_text>"] + list(
            additional_special_tokens or [])
        if bpe_path and os.path.isfile(bpe_path):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges if m]
            chars = list(_bytes_to_unicode().values())
            vocab = chars + [c + "</w>" for c in chars]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(special_tokens)
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
            self.decoder = {i: tok for tok, i in self.encoder.items()}
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
            self.byte_encoder = _bytes_to_unicode()
            self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
            self.vocab_size = len(self.encoder)
            self.sot_id = self.encoder[special_tokens[0]]
            self.eot_id = self.encoder[special_tokens[1]]
            self._special = set(special_tokens)
            self._cache = {}
            self._pat = _clip_word_pattern(special_tokens)
        else:
            self.sot_id = vocab_size - 2
            self.eot_id = vocab_size - 1
            self._pat = None

    def _bpe(self, token: str):
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return word

    def _encode_word(self, word: str):
        if self.encoder is None:
            return [_hash_id(word, self.vocab_size - 2, reserved=1)]
        if word in self._special:
            return [self.encoder[word]]
        btext = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
        return [self.encoder.get(t, 0) for t in self._bpe(btext)]

    def encode(self, text: str):
        """Clean + split + BPE one string to a list of ids (no sot/eot)."""
        text = self.clean_fn(text)
        words = self._pat.findall(text) if self._pat is not None else _basic_tokenize(text)
        ids = []
        for w in words:
            ids.extend(self._encode_word(w))
        return ids

    def decode(self, tokens) -> str:
        """Ids back to text, each word closed by a space (needs the merges
        file: hashed ids do not invert)."""
        if self.encoder is None:
            raise ValueError("decode requires a real BPE vocab")
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        if self.reduction_fn is not None:
            return self.reduction_fn(texts, context_length=context_length,
                                     sot_token_id=self.sot_id, eot_token_id=self.eot_id,
                                     encode_fn=self.encode)
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:  # truncate, force-close with eot
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, : len(ids)] = ids
        return out


class SigLipTokenizer:
    """SigLIP's text tokenizer: the text canonicalised (``basic_clean`` then
    ``canonicalize_text``), sentencepiece ids closed by EOS, padded with the
    pad id (EOS and pad are both 1) to ``context_length``. The vocabulary is
    a local ``T5TokenizerFast`` file or directory ``tokenizer_name`` (read
    with ``transformers``, which then must be installed); without one, each
    word's hash in ``[2, vocab_size)`` gives the ids, the same ids as the JAX
    package's fallback."""

    def __init__(self, tokenizer_name: str | None = None, context_length: int = 64,
                 vocab_size: int = 32000):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.pad_id = 1
        self.eos_id = 1
        self.tokenizer = None
        if tokenizer_name and os.path.exists(tokenizer_name):
            from transformers import T5TokenizerFast

            self.tokenizer = T5TokenizerFast(tokenizer_name, legacy=False)
            self.tokenizer.pad_token_id = 1
            self.tokenizer.eos_token_id = 1

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        texts = [canonicalize_text(basic_clean(t)) for t in texts]
        if self.tokenizer is not None:
            out = self.tokenizer(texts, return_tensors="np", max_length=context_length,
                                 padding="max_length", truncation=True)
            return out.input_ids.astype(np.int32)
        out = np.full((len(texts), context_length), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [_hash_id(w, self.vocab_size, reserved=2) for w in text.split()]
            ids = ids[: context_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out
