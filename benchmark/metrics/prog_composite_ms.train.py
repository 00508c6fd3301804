"""The compositing's device time in the training step (kernel A, and
kernel B in the backward), from the program's spans."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "composite", "composite.bwd")
