"""Training-pair construction with min_length_difference filtering (§III-A).

    min_length_difference = |L_A − L_B| / max(L_A, L_B)  ≥  δ

Pairs below δ are *dropped from training* — their ordering is within the
LLM's natural run-to-run output variance (~20% instruct / ~25% reasoning,
paper Fig. 2) and constitutes noise, not signal. δ defaults per model kind:
0.2 (instruct-class) / 0.25 (reasoning-class).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

DELTA_INSTRUCT = 0.20
DELTA_REASONING = 0.25


def min_length_difference(la: np.ndarray, lb: np.ndarray) -> np.ndarray:
    la = np.asarray(la, np.float64)
    lb = np.asarray(lb, np.float64)
    return np.abs(la - lb) / np.maximum(np.maximum(la, lb), 1.0)


def build_pairs(lengths: np.ndarray, rng: np.random.Generator, *,
                n_pairs: int, delta: float = DELTA_INSTRUCT,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample informative prompt pairs.

    Returns (idx_a, idx_b, y) with y=+1 iff lengths[idx_a] > lengths[idx_b].
    Oversamples then filters by δ, so the returned count can be < n_pairs
    when the length distribution is tight (matches the paper's protocol of
    training only on retained pairs).
    """
    n = len(lengths)
    factor = 4
    ia = rng.integers(0, n, n_pairs * factor)
    ib = rng.integers(0, n, n_pairs * factor)
    keep = (ia != ib) & (min_length_difference(lengths[ia], lengths[ib]) >= delta)
    ia, ib = ia[keep][:n_pairs], ib[keep][:n_pairs]
    y = np.where(lengths[ia] > lengths[ib], 1.0, -1.0).astype(np.float32)
    return ia, ib, y
