"""The field's device time over an image's chunks, from the program's
spans."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.device_ms(ctx, "field")
