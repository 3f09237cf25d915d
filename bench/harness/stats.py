"""Window arithmetic: per-token latency, percentiles, Kendall's tau_b.

The per-token latency of a request is (finish - due time) / output tokens,
as ``Request.per_token_latency`` and ``serving/metrics.py::report`` count
it; percentiles are numpy's linear ones, as ``report`` takes them (both
``src/repro_torch/serving/metrics.py`` at commit 9acff5f). ``kendall_tau_b``
is a frozen copy of ``src/repro_torch/core/predictor/metrics.py`` at the
same commit. A request that failed has no finish; the window counts it as
finishing when serving stopped (``cut``), a bound from below.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def per_token(reqs, cut: float) -> np.ndarray:
    return np.asarray([((r.finish_time if r.finish_time is not None else cut)
                        - r.arrival_time) / r.true_length for r in reqs])


def ttft(reqs, cut: float) -> np.ndarray:
    return np.asarray([(r.first_token_time if r.first_token_time is not None
                        else cut) - r.arrival_time for r in reqs])


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, q)) if len(v) else None


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


def tokens_in_window(tokens_at, window_s: float) -> int:
    """Output tokens emitted by the last step that ended inside the
    window."""
    inside = [n for t, n in tokens_at if t <= window_s]
    return inside[-1] if inside else 0


def paused_in(a: float, b: float, paused) -> float:
    """Seconds of ``[a, b]`` inside the ``(start, end)`` intervals in which
    a traced run's profiler started or stopped and held serving up."""
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in paused)
