"""Mean over the window's requests of (finish - due time) / output tokens,
in s/token: the paper's headline metric (host clock)."""
import numpy as np

from bench.harness import stats


def read(ctx):
    return float(np.mean(stats.per_token(ctx.attempted, ctx.cut)))
