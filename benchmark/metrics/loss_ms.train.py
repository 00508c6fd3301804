"""MSE, VGG19 and antibias losses forward and backward on the step's patches,
between CUDA events."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "loss")
