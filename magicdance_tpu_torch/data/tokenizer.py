"""CLIP BPE tokenizer (the port's own copy of the JAX package's tokenizer).

The reference's FrozenCLIPEmbedder pulls the HF CLIPTokenizer
(ref: ldm/modules/encoders/modules.py:88-101); this is a self-contained
reimplementation of the CLIP byte-pair-encoding scheme that loads the
standard `bpe_simple_vocab_16e6.txt(.gz)` merges file when one is available.

Because training and the shipped inference recipes condition on the EMPTY
string almost exclusively (the `--with_text` flag *disables* text,
ref train_tiktok.py:1396-1397; test scripts pass ""), empty-prompt encoding
is built in and needs no vocab file: [BOS, EOS, EOS...pad] — identical to HF
CLIPTokenizer(pad="<|endoftext|>") output for "".
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

BOS = 49406
EOS = 49407
MAX_LEN = 77


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte → printable-unicode mapping (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """CLIP BPE. `merges_path` points at bpe_simple_vocab_16e6.txt[.gz]."""

    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
        if False  # \p classes need `regex`; fall back to ASCII-ish classes
        else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

    def __init__(self, merges_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks: Optional[dict[tuple[str, str], int]] = None
        self.encoder: Optional[dict[str, int]] = None
        if merges_path is not None:
            self._load_merges(merges_path)

    def _load_merges(self, path: str) -> None:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with open(path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        pairs = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for p in pairs:
            vocab.append("".join(p))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {p: i for i, p in enumerate(pairs)}
        self._cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def _bpe(self, token: str) -> str:
        assert self.bpe_ranks is not None
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_text(self, text: str) -> list[int]:
        if text == "":
            return []
        if self.encoder is None:
            raise RuntimeError(
                "non-empty prompts need a CLIP BPE merges file; construct "
                "CLIPTokenizer(merges_path=...) with bpe_simple_vocab_16e6.txt[.gz]"
            )
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: list[int] = []
        for tok in self._PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = MAX_LEN) -> np.ndarray:
        """Batch-encode to (B, max_length) int32 with BOS/EOS + EOS padding,
        truncation semantics matching HF CLIPTokenizer(truncation=True)."""
        out = np.full((len(texts), max_length), EOS, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = self.encode_text(t)[: max_length - 2]
            row = [BOS] + ids + [EOS]
            out[i, : len(row)] = row
        return out


def empty_prompt_ids(batch: int, max_length: int = MAX_LEN) -> np.ndarray:
    """Token ids for "" — the dominant conditioning signal in MagicPose."""
    out = np.full((batch, max_length), EOS, dtype=np.int32)
    out[:, 0] = BOS
    return out
