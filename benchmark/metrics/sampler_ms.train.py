"""The depth-guided sampler and the uniform fill-up over the step's rays (with
NOVEL's candidate deformation), between CUDA events."""

from benchmark.metrics._share import span


def read(ctx):
    return span(ctx, "sampler")
