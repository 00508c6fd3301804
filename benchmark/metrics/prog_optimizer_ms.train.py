"""The optimizer's device time in the training step (zero_grad, the
gradients completed, Adam), from the program's spans."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "optimizer")
