"""The hash tokenizer, copied from ``src/repro_torch/core/predictor/
tokenizer.py`` at commit 9acff5f so that the reference tokenizes on its
own: lowercase, words of ``[a-z0-9]+``, ``[CLS]`` first, each word's
FNV-1a hash into ``vocab_size - 3`` ids after the three special ones, cut
at ``max_len``."""
from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

PAD, CLS = 0, 1
N_SPECIAL = 3
_WORD = re.compile(r"[a-z0-9]+")


def _fnv1a(word: str) -> int:
    h = 0xcbf29ce484222325
    for ch in word.encode():
        h = ((h ^ ch) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


def encode(text: str, vocab_size: int, max_len: int) -> List[int]:
    ids = [CLS] + [N_SPECIAL + _fnv1a(w) % (vocab_size - N_SPECIAL)
                   for w in _WORD.findall(text.lower())]
    return ids[:max_len]


def encode_batch(texts: Sequence[str], vocab_size: int,
                 max_len: int) -> np.ndarray:
    """(N, max_len) int64, PAD-padded."""
    out = np.full((len(texts), max_len), PAD, np.int64)
    for i, t in enumerate(texts):
        ids = encode(t, vocab_size, max_len)
        out[i, :len(ids)] = ids
    return out
