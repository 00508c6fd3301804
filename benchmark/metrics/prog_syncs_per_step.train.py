"""Synchronizing CUDA operations the training step makes, counted inside
the program."""

from benchmark.metrics import _prog


def read(ctx):
    return _prog.syncs(ctx, "train_step")
