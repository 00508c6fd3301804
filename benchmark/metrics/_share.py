"""Arithmetic the per-layer readers share. A reader's ``read(ctx)`` takes
the traced stretch's context (see ``benchmark/drivers``) and returns a
number, or None where the trace holds nothing for it."""

from __future__ import annotations

import importlib


def idle_pct(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx):
    c = ctx["cell"].config
    dtype = c["compute_dtype"] if not (c["compute_dtype"] == "float32"
                                       and c["tf32"]) else "tf32"
    peak = ctx["peaks"]["flops_per_s"][dtype]
    t = ctx["trace"]
    return 100.0 * ctx["flops_per_unit"] * ctx["units"] / t["window_s"] / peak


def per_unit(ctx, value):
    return value / ctx["units"]


def roofline_pct(ctx, kernel_file: str):
    """100 × the least time of the kernels' work over their device time in
    the trace, from ``benchmark/kernels/<kernel_file>.py``; None where the
    trace holds none of them."""
    from benchmark import harness
    mod = importlib.import_module(f"benchmark.kernels.{kernel_file}")
    seconds = harness.kernel_seconds(ctx["trace"], mod.KERNELS)
    if seconds <= 0:
        return None
    bound = mod.bound_s(ctx["cell"].config, ctx["kind"], ctx["peaks"])
    return 100.0 * bound * ctx["units"] / seconds


def span(ctx, name):
    return ctx["spans"].get(name)
