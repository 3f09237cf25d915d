"""Shared arithmetic of the ``step_ms`` and ``step_mfu`` readers."""
import numpy as np

from bench.harness import peaks, stats


def step_ms(ctx):
    """Mean wall of the serving steps inside the window, in ms (each step
    from its scheduling call to its end, as ``on_step`` sees it; a step
    that the profiler's start or stop held up is left out)."""
    paused = ctx.window.paused
    steps = [(a, b) for a, b, _ in ctx.window.steps
             if b <= ctx.T and not stats.paused_in(a, b, paused)]
    if not steps:
        return None
    return 1e3 * sum(b - a for a, b in steps) / len(steps)


def step_mfu(ctx):
    """Useful FLOPs (the architecture's ``tokens_flops``) of the prompt and
    output tokens processed inside the window, over the window's seconds
    (less the profiler's start and stop) and the bf16 peak, in %."""
    m = ctx.model
    w = ctx.window
    pos = [np.arange(a, b) for t, a, b in w.prefill_tokens if t <= ctx.T]
    pos += [np.asarray(p) for t, p, _ in w.decode_calls if t <= ctx.T]
    total = ctx.arch.tokens_flops(m, np.concatenate(pos)) if pos else 0.0
    seconds = ctx.T - stats.paused_in(0.0, ctx.T, w.paused)
    return 100.0 * total / seconds / peaks.BF16_FLOPS if total else None
