"""Kernels: the paged decode kernel's share of its roofline in the
profiled slice of the batch cell, in % (device trace)."""
from bench.metrics._decode_roofline import roofline


def read(ctx):
    return roofline(ctx, "paged_decode_", paged=True)
