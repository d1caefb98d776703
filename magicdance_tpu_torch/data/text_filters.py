"""Caption/text quality filters for video-text datasets.

Rebuild of the reference's dataset-side text filtering
(ref: dataset/tiktok_video_mm.py:190-218 — drops samples whose captions are
NSFW, non-English, or numeric-dominated; dataset/safty.py provides the
blocked-word list). The word list here is intentionally small and
user-extensible (`extra_blocklist` / a newline-delimited file) rather than
vendoring the reference's 454-line list.

The PyTorch port's own copy of `magicdance_tpu.data.text_filters`
(framework-free).
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

_DEFAULT_BLOCKLIST = frozenset({
    "nsfw", "nude", "nudity", "naked", "porn", "pornographic", "sex",
    "sexual", "explicit", "xxx", "erotic", "fetish", "hentai",
})

_NON_ASCII = re.compile(r"[^\x00-\x7F]")
_DIGITS = re.compile(r"\d")


class TextFilter:
    def __init__(
        self,
        extra_blocklist: Optional[Iterable[str]] = None,
        blocklist_file: Optional[str] = None,
        max_non_ascii_frac: float = 0.1,
        max_digit_frac: float = 0.3,
        min_words: int = 0,
    ):
        words = set(_DEFAULT_BLOCKLIST)
        if extra_blocklist:
            words.update(w.strip().lower() for w in extra_blocklist)
        if blocklist_file:
            with open(blocklist_file) as f:
                words.update(w.strip().lower() for w in f if w.strip())
        self.blocklist = frozenset(words)
        self.max_non_ascii_frac = max_non_ascii_frac
        self.max_digit_frac = max_digit_frac
        self.min_words = min_words

    def ok(self, text: str) -> bool:
        """True when a caption passes all filters (empty always passes — the
        dominant conditioning is the empty string)."""
        if not text:
            return True
        lower = text.lower()
        tokens = re.findall(r"[a-z']+", lower)
        if any(t in self.blocklist for t in tokens):
            return False
        n = max(len(text), 1)
        if len(_NON_ASCII.findall(text)) / n > self.max_non_ascii_frac:
            return False  # language filter (reference: English-only)
        if len(_DIGITS.findall(text)) / n > self.max_digit_frac:
            return False  # numeric-dominated
        if len(tokens) < self.min_words:
            return False
        return True

    def __call__(self, text: str) -> bool:
        return self.ok(text)
