"""Kernels: the ring decode kernel's share of its roofline in the profiled
slice, in % (device trace)."""
from bench.metrics._decode_roofline import roofline


def read(ctx):
    return roofline(ctx, "ring_decode_", paged=False)
