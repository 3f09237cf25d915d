"""Scheduler and core: mean rows of the decode steps inside the window
(program counter: the rows the engine decoded at each step)."""
import numpy as np


def read(ctx):
    rows = [len(p) for t, p, _ in ctx.window.decode_calls if t <= ctx.T]
    return float(np.mean(rows)) if rows else None
