"""Device idle share over a traced stretch of training steps: 1 - union of
device-op intervals / the stretch."""

from benchmark.metrics._share import idle_pct


def read(ctx):
    return idle_pct(ctx)
