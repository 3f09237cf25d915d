"""Kendall rank correlation τ_b (tie-corrected), exactly as in the paper §IV:

    τ_b = (n_c − n_d) / sqrt((n_0 − n_1)(n_0 − n_2))

with n_0 = n(n−1)/2 and n_1 / n_2 the tied-pair counts of each variable.
"""
from __future__ import annotations

import numpy as np


def kendall_tau_b(x, y) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    assert len(y) == n and n >= 2
    dx = np.sign(x[:, None] - x[None, :])
    dy = np.sign(y[:, None] - y[None, :])
    iu = np.triu_indices(n, k=1)
    prod = dx[iu] * dy[iu]
    n_c = int(np.sum(prod > 0))
    n_d = int(np.sum(prod < 0))
    n0 = n * (n - 1) // 2
    n1 = int(np.sum(dx[iu] == 0))
    n2 = int(np.sum(dy[iu] == 0))
    denom = np.sqrt(float(n0 - n1) * float(n0 - n2))
    return float((n_c - n_d) / denom) if denom > 0 else 0.0
