"""CLIP BPE tokenizer, pure Python (a copy of
`imagdressing_tpu/apps/tokenizer.py`; the port imports nothing of the JAX
package).

Loads vocab.json + merges.txt from a local tokenizer directory (the
`tokenizer/` subfolder of any SD1.5 checkpoint; the reference loads the same
files through transformers' CLIPTokenizer).
Produces padded 77-token id arrays: BOS, ids..., EOS, then EOS-padding
(CLIP pads with the eos token id).

`HashTokenizer` is a deterministic stand-in for tests/benchmarks when no
vocab files exist in the image (zero-egress environment).
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import List

import numpy as np


@functools.lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-pair-encoding tokenizer with the CLIP regex + <|startoftext|> /
    <|endoftext|> specials."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        with open(vocab_path, "r", encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_path, "r", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # merges.txt has a version header line
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # ASCII approximation of CLIP's \p{L}/\p{N} word pattern (stdlib
        # `re` has no Unicode property classes): non-ASCII letters fall to
        # the punctuation class and can split differently than the HF
        # tokenizer — byte-level BPE still covers them, but ids for e.g.
        # accented words may differ
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.max_length = max_length

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token_b).split(" "))
        return ids

    def __call__(self, text: str) -> np.ndarray:
        """-> (max_length,) int32, BOS + ids + EOS, EOS-padded, truncated."""
        ids = self.encode(text)[: self.max_length - 2]
        full = [self.bos] + ids + [self.eos]
        full = full + [self.eos] * (self.max_length - len(full))
        return np.asarray(full, np.int32)

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        return cls(
            os.path.join(path, "vocab.json"),
            os.path.join(path, "merges.txt"),
            max_length,
        )


class HashTokenizer:
    """Deterministic test/bench stand-in: hashes words into the id space."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos = vocab_size - 2, vocab_size - 1

    def __call__(self, text: str) -> np.ndarray:
        import hashlib

        ids = [
            int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
            for w in text.lower().split()
        ][: self.max_length - 2]
        full = [self.bos] + ids + [self.eos]
        full += [self.eos] * (self.max_length - len(full))
        return np.asarray(full, np.int32)


def load_tokenizer(path: str = "", max_length: int = 77):
    """CLIP BPE when vocab files exist locally; Hash fallback otherwise."""
    if path and os.path.exists(os.path.join(path, "vocab.json")):
        return CLIPTokenizer.from_dir(path, max_length)
    return HashTokenizer(max_length=max_length)
