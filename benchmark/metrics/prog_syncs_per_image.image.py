"""Synchronizing CUDA operations the eval image makes, counted inside the
program."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.syncs(ctx, "eval_image")
