"""Engine: ``RealBackend.prefill_seconds`` gained while serving, as a
share of the serving wall (window and drain) less the seconds in which the
profiler's start or stop held serving up, in % (program counter)."""
from bench.harness import stats


def read(ctx):
    w = ctx.window
    wall = w.serve_s - stats.paused_in(0.0, w.serve_s, w.paused)
    return 100.0 * w.prefill_s / wall if wall > 0 else None
