"""CLIP BPE tokenizer (host-side, pure Python): the port's own copy of the
JAX package's `host/tokenizer.py`.

Prompts are tokenized as `transformers.CLIPTokenizer` does for SD: BOS,
byte-level BPE with CLIP's end-of-word markers, EOS, truncated and
EOS-padded to max_length=77. Vocab and merges load from local files (an HF
tokenizer directory or openai's bpe_simple_vocab); nothing is fetched.
"""

from __future__ import annotations

import gzip
import html
import json
import os
from functools import lru_cache
from typing import List, Sequence

import numpy as np

try:  # CLIP's pattern needs unicode classes; `regex` ships with transformers
    import regex as re

    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    import re

    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
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


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word markers and special tokens."""

    def __init__(self, vocab: dict, merges: Sequence[tuple], max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = vocab["<|startoftext|>"]
        self.eos = vocab["<|endoftext|>"]
        self.cache = {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from an HF tokenizer dir (vocab.json + merges.txt) or an
        openai bpe_simple_vocab_16e6.txt(.gz)."""
        vj, mt = os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            with open(vj) as f:
                vocab = json.load(f)
            with open(mt) as f:
                lines = f.read().split("\n")
            merges = [tuple(l.split()) for l in lines if l and not l.startswith("#")]
            return cls(vocab, merges, max_length)
        if os.path.isfile(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                raw = f.read().split("\n")
            merges = [tuple(m.split()) for m in raw[1 : 49152 - 256 - 2 + 1]]
            byte_vocab = list(bytes_to_unicode().values())
            tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
            tokens += ["".join(m) for m in merges]
            tokens += ["<|startoftext|>", "<|endoftext|>"]
            vocab = {t: i for i, t in enumerate(tokens)}
            return cls(vocab, merges, max_length)
        raise FileNotFoundError(f"No tokenizer files at {path}")

    # -- BPE -----------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str, pad: bool = True) -> List[int]:
        """Token ids with BOS/EOS, truncated and EOS-padded to max_length —
        the `tokenize_text` contract (diffusion_utils.py:34-44)."""
        ids = [self.bos]
        for token in _PAT.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        ids = ids[: self.max_length - 1] + [self.eos]
        if pad:
            ids = ids + [self.eos] * (self.max_length - len(ids))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """(N, max_length) int32 ids of one string or a list of them."""
        if isinstance(texts, str):
            texts = [texts]
        return np.asarray([self.encode(t) for t in texts], np.int32)
