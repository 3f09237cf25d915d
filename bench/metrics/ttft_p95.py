"""95th percentile of the time to first token, from each request's due
time, over every request due in the window, in s (host clock)."""
from bench.harness import stats


def read(ctx):
    return stats.percentile(stats.ttft(ctx.attempted, ctx.cut), 95)
