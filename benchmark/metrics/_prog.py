"""Readers of the program's own spans and sync counts over the traced
stretch (``diner_tpu_torch.utils.profiling``: ``span``, ``mark``,
``take``). The spans are taken once a run and kept in the readers'
context, since taking them drains them. A program without spans, or a
stretch that left none, reads None: the metric is left out."""

from __future__ import annotations


def spans(ctx) -> list:
    if "prog_spans" not in ctx:
        from diner_tpu_torch.utils import profiling
        take = getattr(profiling, "take", None)
        ctx["prog_spans"] = take() if take is not None else []
    return ctx["prog_spans"]


def device_ms(ctx, *names):
    """Device milliseconds a unit of the spans named ``names``."""
    got = [s.device_ms for s in spans(ctx) if s.name in names]
    return sum(got) / ctx["units"] if got else None


def host_ms(ctx, root: str):
    """Host milliseconds a unit of the root spans named ``root``."""
    got = [s.host_ms for s in spans(ctx) if s.name == root]
    return sum(got) / ctx["units"] if got else None


def syncs(ctx, root: str):
    """Synchronizing CUDA operations a unit inside the root spans named
    ``root``."""
    roots = {s.root for s in spans(ctx) if s.name == root
             and s.parent is None}
    if not roots:
        return None
    return sum(s.syncs for s in spans(ctx) if s.root in roots) / ctx["units"]
