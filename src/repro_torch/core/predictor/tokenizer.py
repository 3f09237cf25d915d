"""Deterministic hash tokenizer for the ranking predictor.

The paper uses BERT-base-uncased's WordPiece vocabulary; offline we use a
stable-hash word tokenizer (lowercase, split on non-alphanumerics, FNV-1a into
the vocab). What matters for the method is that prompt semantics map to
consistent token ids the predictor can learn from — which a hash vocab
provides (collisions act as mild label noise).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

PAD, CLS, UNK = 0, 1, 2
N_SPECIAL = 3
_WORD = re.compile(r"[a-z0-9]+")


def _fnv1a(word: str) -> int:
    h = 0xcbf29ce484222325
    for ch in word.encode():
        h = ((h ^ ch) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class HashTokenizer:
    vocab_size: int = 2048
    max_len: int = 32

    def encode(self, text: str) -> List[int]:
        words = _WORD.findall(text.lower())
        ids = [CLS] + [N_SPECIAL + _fnv1a(w) % (self.vocab_size - N_SPECIAL)
                       for w in words]
        return ids[: self.max_len]

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        """(N, max_len) int32, PAD-padded; row 0 is always [CLS]."""
        out = np.full((len(texts), self.max_len), PAD, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out
