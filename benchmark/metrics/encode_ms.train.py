"""The encoder's forward and backward at the step's shapes, between CUDA events
around the benchmark's own call."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "encode")
