"""The field's forward and backward over the step's samples, between CUDA
events around the benchmark's own call."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "field")
