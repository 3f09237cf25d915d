"""Token samplers for the serving engine: greedy / temperature / top-k / top-p.

Port of ``repro/serving/sampler.py``: the same kept-set rule (top-k keeps
logits >= the k-th largest; top-p keeps the smallest prefix of the sorted
distribution whose mass reaches ``top_p``), with draws from an explicit
``torch.Generator``. The engine defaults to greedy, for deterministic tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0        # 0 = greedy
    top_k: int = 0                  # 0 = full vocab
    top_p: float = 1.0              # nucleus; 1.0 = off


def filter_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """Temperature-scaled f32 logits with every token outside the kept set
    at ``-inf``. logits: (..., V)."""
    lf = logits.float() / cfg.temperature
    neg_inf = torch.tensor(float("-inf"), device=lf.device)
    if cfg.top_k and cfg.top_k < lf.shape[-1]:
        kth = torch.sort(lf, dim=-1).values[..., -cfg.top_k][..., None]
        lf = torch.where(lf < kth, neg_inf, lf)
    if cfg.top_p < 1.0:
        sorted_lf = torch.sort(lf, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lf, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative mass >= top_p: find the cutoff logit
        keep = cum - probs < cfg.top_p
        cutoff = torch.where(keep, sorted_lf,
                             torch.tensor(float("inf"), device=lf.device))
        cutoff = cutoff.min(dim=-1, keepdim=True).values
        lf = torch.where(lf < cutoff, neg_inf, lf)
    return lf


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           cfg: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """logits: (B, V) -> token ids (B,) int64. Greedy ties go to the first
    maximal index, as ``jnp.argmax``."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filter_logits(logits, cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
