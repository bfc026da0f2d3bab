"""CLIP text tokenization (numpy only).

A copy of ``mvd_tpu/data/tokenizer.py``, kept in the port so that it imports
nothing of the JAX package. ``CLIPBPETokenizer`` reads ``vocab.json`` and
``merges.txt`` from a local SD checkpoint directory (byte-level BPE,
lowercased, 77-token context with <|startoftext|>/<|endoftext|> framing and
endoftext padding). Without those files ``HashTokenizer`` stands in: same
contract (ids < vocab_size, BOS/EOS framing, fixed length), stable across
runs, and not prompt-faithful.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import os
import re
from functools import lru_cache
from typing import List, Optional

import numpy as np

# CLIP's tokenization regex; the upstream pattern uses \p{L}/\p{N} unicode
# classes (regex module) — stdlib `re` approximates with ASCII classes,
# which matches the corpus prompts this framework tokenizes.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """CLIP byte-pair tokenizer from local vocab/merges files."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eos = self.encoder.get("<|endoftext|>", 49407)
        self.cache = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in re.findall(_PAT, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when no vocab files are available: words map to
    stable pseudo-ids. Keeps the BOS/EOS/pad framing of the real tokenizer so
    the text-encoder contract (shapes, framing, padding) is exercised."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def encode_text(self, text: str) -> List[int]:
        words = _whitespace_clean(_basic_clean(text)).lower().split()
        ids = []
        for w in words:
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(
    checkpoint_dir: Optional[str] = None,
    vocab_size: int = 49408,
    max_length: int = 77,
):
    """CLIPBPETokenizer if vocab files are found, else HashTokenizer."""
    if checkpoint_dir:
        for sub in ("tokenizer", "."):
            vocab = os.path.join(checkpoint_dir, sub, "vocab.json")
            merges = os.path.join(checkpoint_dir, sub, "merges.txt")
            if os.path.exists(vocab) and os.path.exists(merges):
                return CLIPBPETokenizer(vocab, merges, max_length)
    return HashTokenizer(vocab_size, max_length)
