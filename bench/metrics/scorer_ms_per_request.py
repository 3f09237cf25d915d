"""Ranking layer: host milliseconds inside the scorer the policy calls,
per request scored, over the window (program span: the benchmark's timed
wrapper around the predictor's ``score``)."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.scorer_s / w.scored if w.scored else None
