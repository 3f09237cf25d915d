"""Learning-to-rank losses: margin-ranking (PARS), L1 pointwise, ListMLE.

Port of ``repro/core/predictor/losses.py``, with the reference's formulas.
The margin ranking loss is the paper's eq. in §III-A:
    L(s_A, s_B, y) = max(0, -y · (s_A - s_B) + margin),   margin = 1.0
with y = +1 when prompt A's response is expected to be *longer*.

At the kinks the gradients are the ones ``jax.grad`` takes:
``torch.maximum`` gives half to each side of a tie, as ``jnp.maximum``
does, and the L1 loss takes |d| as ``where(d >= 0, d, -d)``, whose slope at
0 is +1 as ``jnp.abs``'s (``torch.abs`` has slope 0 there).
"""
from __future__ import annotations

import torch

POINTWISE_SCALE = 100.0  # tokens per score unit — a practitioner-reasonable
# normalization for instruct-length outputs; reasoning-length outliers then
# dominate the L1 objective, which is exactly the pointwise failure mode the
# paper exploits (§II, Table II)


def margin_ranking_loss(s_a: torch.Tensor, s_b: torch.Tensor,
                        y: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Paper §III-A. s_a/s_b: (B,) scores; y: (B,) in {+1, -1}."""
    hinge = -y * (s_a - s_b) + margin
    return torch.maximum(torch.zeros_like(hinge), hinge).mean()


def l1_pointwise_loss(scores: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Pointwise SJF baseline [Qiu et al.]: regression with L1 loss on the
    response length (scaled — τ_b only depends on ordering)."""
    d = scores - lengths.float() / POINTWISE_SCALE
    return torch.where(d >= 0, d, -d).mean()


def listmle_loss(scores: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Listwise SJF baseline [Fu et al., ListMLE]: negative log-likelihood of
    the ground-truth descending-length permutation under the Plackett-Luce
    model. scores/lengths: (B, L) — B lists of L items. Ties in length keep
    their order (a stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(-lengths, dim=-1, stable=True)   # longest first
    s = torch.gather(scores, -1, order)                    # (B, L)
    # log P = Σ_i [ s_i − logsumexp(s_i..s_L) ]  (suffix logsumexp)
    suffix_lse = torch.logcumsumexp(s.flip(1), dim=1).flip(1)
    return -(s - suffix_lse).sum(-1).mean()
