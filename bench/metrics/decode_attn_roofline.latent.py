"""Kernels: the latent (MLA) decode kernel's share of its roofline in the
profiled slice of a burst cell, in % (device trace): the architecture's
least time of the slice's decode steps over the split and merge kernels'
device time."""
from bench.metrics._decode_roofline import roofline


def read(ctx):
    return roofline(ctx, "latent_decode_", paged=True)
