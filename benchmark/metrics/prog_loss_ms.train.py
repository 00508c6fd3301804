"""The losses' device time in the training step (MSE, VGG, antibias),
forward and backward, from the program's spans."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "loss", "loss.bwd")
