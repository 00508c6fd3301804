"""The depth-guided sampler's and fill-up's device time in the training
step (NOVEL's with the kNN deformation), from the program's span."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "sampler")
