"""90th percentile over every request due in the window of
(finish - due time) / output tokens, in s/token (host clock)."""
from bench.harness import stats


def read(ctx):
    return stats.percentile(stats.per_token(ctx.attempted, ctx.cut), 90)
