"""Ranking layer: Kendall's tau_b between the predictor's score
(``Request.score``) and the true output length over the window's
requests (program counter)."""
from bench.harness import stats


def read(ctx):
    reqs = [r for r in ctx.attempted if r.scored]
    if len(reqs) < 2:
        return None
    return stats.kendall_tau_b([r.score for r in reqs],
                               [r.true_length for r in reqs])
