"""Scheduler and core: 95th percentile of start_time - arrival_time
(admission wait) over the window's requests that were admitted, less the
seconds in which the profiler's start or stop held serving up (program
counter)."""
from bench.harness import stats


def read(ctx):
    paused = ctx.window.paused
    return stats.percentile([r.start_time - r.arrival_time
                             - stats.paused_in(r.arrival_time, r.start_time,
                                               paused)
                             for r in ctx.attempted
                             if r.start_time is not None], 95)
