"""The top-1 kNN: least time of a step's three searches
(benchmark/kernels/knn.py) over its device time in the trace."""

from benchmark.metrics._share import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "knn")
