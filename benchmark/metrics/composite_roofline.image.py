"""Kernel A: least time of an image's compositing
(benchmark/kernels/composite.py) over its device time in the trace."""

from benchmark.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "composite")
