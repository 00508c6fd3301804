"""Model FLOPs of the traced image (benchmark/flops.py) over the stretch's
length and the configuration precision's published peak."""

from benchmark.metrics._share import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
