"""Output tokens emitted inside the window over the window's seconds
(host clock; every token a step committed by the last step that ended
inside the window)."""
from bench.harness import stats


def read(ctx):
    return stats.tokens_in_window(ctx.window.tokens_at, ctx.T) / ctx.T
