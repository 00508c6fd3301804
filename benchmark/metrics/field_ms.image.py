"""The field's forward over one whole image's samples, chunk by chunk, between
CUDA events."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "field")
