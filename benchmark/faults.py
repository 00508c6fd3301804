"""Planting a fault under the timed path, for the checks that a broken run
comes out not correct (``tests/test_bench_faults.py`` on the CPU,
``calibrate.py --faults`` on the card).

A fault is a function of ``mp``, anything with pytest's
``monkeypatch.setattr(obj, name, value)``. Each traffic driver lists the
faults its cells can have as its ``FAULTS``; those that patch the driver
itself live beside it, and the one that patches the program's kernel
for every driver lives here.
"""

from __future__ import annotations

import contextlib


def answer_altered(mp):
    """The composited colour shifted by 0.05 where kernel A produces it."""
    from diner_tpu_torch.ops import composite_cuda
    composite = composite_cuda.composite

    def broken(*a, **k):
        out = composite(*a, **k)
        return out._replace(rgb=out.rgb + 0.05)
    mp.setattr(composite_cuda, "composite", broken)


class _Patch:
    def __init__(self):
        self.undo = []

    def setattr(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)


@contextlib.contextmanager
def planted(fault):
    p = _Patch()
    fault(p)
    try:
        yield
    finally:
        for obj, name, value in reversed(p.undo):
            setattr(obj, name, value)
