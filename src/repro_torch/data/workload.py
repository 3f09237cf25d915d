"""Workload construction: arrival processes + Request materialization."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler.request import Request
from repro_torch.data.synthetic import Corpus, prompt_lengths


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """n arrival times with exponential inter-arrival gaps (req/s)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return np.cumsum(gaps)


def burst_arrivals(n: int) -> np.ndarray:
    """Paper §IV-D burst scenario: n simultaneous requests at t=0."""
    return np.zeros(n)


def make_requests(corpus: Corpus, lengths: Sequence[int],
                  arrivals: Sequence[float],
                  indices: Optional[Sequence[int]] = None) -> List[Request]:
    """Materialize Requests from corpus rows (optionally a subset)."""
    idx = list(indices) if indices is not None else list(range(len(arrivals)))
    plens = prompt_lengths([corpus.prompts[j] for j in idx])
    return [
        Request(req_id=i,
                prompt=corpus.prompts[j],
                arrival_time=float(arrivals[i]),
                prompt_len=int(plens[i]),
                true_length=int(lengths[j]))
        for i, j in enumerate(idx)
    ]
