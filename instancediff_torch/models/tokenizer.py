"""Host-side tokenizers (copy of ``ClipBPETokenizer``,
``BertWordPieceTokenizer`` and the helpers they need from
``instancediff_tpu/models/tokenizer.py``).

With a BPE merges file ``ClipBPETokenizer`` splits and byte-pair-encodes as
CLIP's SimpleTokenizer does; with a ``vocab.txt`` ``BertWordPieceTokenizer``
splits words into greedy longest-match WordPiece pieces. Without the file,
a deterministic hash of each word gives stable ids, the same ids as the JAX
package's fallback."""

from __future__ import annotations

import gzip
import hashlib
import html
import os
import re

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


def _clean_lower(x: str) -> str:
    return whitespace_clean(basic_clean(x)).lower()


def _hash_id(token: str, vocab_size: int, reserved: int = 10) -> int:
    h = int.from_bytes(hashlib.sha256(token.encode()).digest()[:4], "little")
    return reserved + (h % (vocab_size - reserved))


_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


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
    the hash fallback (sot = vocab_size-2, eot = vocab_size-1)."""

    def __init__(self, bpe_path: str | None = None, context_length: int = 42,
                 vocab_size: int = 49408):
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.encoder = None
        special_tokens = ["<start_of_text>", "<end_of_text>"]
        if bpe_path and os.path.isfile(bpe_path):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")[1: 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges if m]
            chars = list(_bytes_to_unicode().values())
            vocab = chars + [c + "</w>" for c in chars]
            vocab.extend("".join(m) for m in merges)
            vocab.extend(special_tokens)
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
            self.bpe_ranks = {m: i for i, m in enumerate(merges)}
            self.byte_encoder = _bytes_to_unicode()
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
        text = _clean_lower(text)
        words = self._pat.findall(text) if self._pat is not None else _basic_tokenize(text)
        ids = []
        for w in words:
            ids.extend(self._encode_word(w))
        return ids

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:  # truncate, force-close with eot
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, : len(ids)] = ids
        return out
