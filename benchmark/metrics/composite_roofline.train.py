"""Kernels A and B: least time of a step's compositing
(benchmark/kernels/composite.py) over their device time in the trace."""

from benchmark.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "composite")
