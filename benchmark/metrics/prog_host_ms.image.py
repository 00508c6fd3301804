"""The host's time in the eval image, its root span on the host clock
(under the profiler)."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.host_ms(ctx, "eval_image")
