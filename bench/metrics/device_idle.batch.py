"""Device: share of the profiled slice in which no kernel or copy ran
(union of the device intervals), in %, in the batch cells (device trace)."""


def read(ctx):
    s = ctx.window.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
