"""Kernel C: least time of a step's row gathers
(benchmark/kernels/row_gather.py) over its device time in the trace."""

from benchmark.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "row_gather")
