"""Device kernels in the trace per training step (copies and fills left
out)."""

from benchmark.metrics._share import per_unit


def read(ctx):
    return per_unit(ctx, ctx["trace"]["kernels"])
