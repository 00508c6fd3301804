"""The field's device time in the training step: its forward span and its
part of the backward, between CUDA events inside the program."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "field", "field.bwd")
