"""The depth-guided sampler and the fill-up over one whole image's rays, chunk
by chunk, between CUDA events."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "sampler")
