"""Where a benchmark cell's step or image spends its time, read from the
program's spans (``diner_tpu_torch/utils/profiling.py``).

Builds the cell's program as its driver does (``benchmark/drivers/``), runs
the driver's warm-up, then the cell's traced units under
``torch.profiler`` on the card, and writes as JSON, a unit each:

- every span name's device and host milliseconds, count and syncs;
- the sums the spans should tile: the train step's six layers (optimizer,
  encode, sampler, field, composite, loss, each with its part of the
  backward) or the image's encode, sampler, field and composite, against
  the traced window; the backward's parts against the backward;
- the device's longest idle gaps, each with the innermost program span
  and the op the host was in (the op as ``benchmark/harness.py`` names
  it);
- then one more unit with the profiler off and
  ``torch.cuda.set_sync_debug_mode("warn")``: the ``file:line`` of each
  synchronizing CUDA operation it made;
- with ``--on-cost R``: what the spans cost under the profiler, from ``R``
  rounds of two traced stretches, one with the spans and one with
  ``span`` and ``mark`` replaced by no-ops, in turns (on, off, off, on,
  ...): each stretch's host time to its last device op, a unit. The
  garbage each traced stretch leaves (the profiler's events hold cycles)
  is collected between stretches, outside the timing.

    python3 lab/step_spans.py --workload diner_dtu.train --seed 7 \\
        --out outputs/spans.diner_dtu.train.json

Not part of the package or the benchmark.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from diner_tpu_torch.utils import profiling  # noqa: E402

SPANS = ("train_step", "eval_image", "optimizer", "encode", "sampler",
         "field", "composite", "loss", "backward")
TRAIN_LAYERS = ("optimizer", "encode", "encode.bwd", "sampler", "field",
                "field.bwd", "composite", "composite.bwd", "loss",
                "loss.bwd")
IMAGE_LAYERS = ("encode", "sampler", "field", "composite")
PARTS = ("loss.bwd", "composite.bwd", "field.bwd", "encode.bwd")


def units_of(cell, seed: int, device="cuda"):
    """(run(i): unit i of the traced stretch, units traced), after the
    driver's warm-up."""
    drv = cell.driver
    harness.set_tf32(cell)
    if cell.traffic["driver"] == "train_step":
        pool = drv.make_pool(cell, seed, device)
        _, step = drv.build_program(cell, seed, device)
        call = drv.program_call(step)
        for i in range(drv.FIRST_STEPS):
            call(pool[i])
        return (lambda i: call(pool[(drv.FIRST_STEPS + i) % len(pool)]),
                cell.traffic["trace_steps"])
    scenes = drv.make_scenes(cell, seed, device)
    _, _, step = drv.build_program(cell, seed, device)

    def image(i):
        return step(scenes[i % len(scenes)],
                    noise=drv.image_noise(cell, seed, i, device))
    image(0)
    return (lambda i: image(i + 1)), cell.traffic["trace_images"]


def traced(run, n: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for i in range(n):
                run(i)
            torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("bench.")]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    win = next(e for e in host if e.name == "bench.window")
    start = win.time_range.start
    end = max([win.time_range.end] + [e.time_range.end for e in dev])
    busy = harness._union([(max(e.time_range.start, start), e.time_range.end)
                           for e in dev if e.time_range.end > start])
    gaps = [(s, e) for (_, s), (e, _) in zip(
        [[start, start]] + busy, busy + [[end, end]]) if e > s]
    spans = [h for h in host if h.name in SPANS]
    ops = [h for h in host if not h.name.startswith("bench.")
           and h.name not in SPANS]

    def innermost(pool, s, e):
        over = [(min(e, h.time_range.end) - max(s, h.time_range.start),
                 -h.time_range.elapsed_us(), h.name) for h in pool]
        o, _, name = max(over, default=(0, 0, "host"))
        return name if o > 0 else "host"

    def containing(s, e):
        mid = (s + e) / 2
        inside = [h for h in spans
                  if h.time_range.start <= mid <= h.time_range.end]
        return min(inside, key=lambda h: h.time_range.elapsed_us()
                   ).name if inside else "host"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:12]
    return {
        "window_ms": (end - start) / 1e3 / n,
        "busy_ms": sum(e - s for s, e in busy) / 1e3 / n,
        "kernels": sum(1 for e in dev if not e.name.startswith(
            ("Memcpy", "Memset"))) / n,
        "idle_gaps": [{"ms": (e - s) / 1e3, "span": containing(s, e),
                       "op": innermost(ops, s, e)} for s, e in longest],
        "idle_ms_by_span": _idle_by_span(gaps, containing, n),
    }


def _idle_by_span(gaps, containing, n):
    out = collections.Counter()
    for s, e in gaps:
        out[containing(s, e)] += (e - s) / 1e3 / n
    return dict(out.most_common())


def sync_sites(run, i: int) -> dict:
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(i)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    sites = collections.Counter(
        f"{Path(w.filename).resolve().relative_to(ROOT)}:{w.lineno}"
        if Path(w.filename).resolve().is_relative_to(ROOT)
        else f"{w.filename}:{w.lineno}"
        for w in caught if str(w.message).startswith(profiling.SYNC_WARNING))
    return dict(sites.most_common())


def on_cost(run, n: int, rounds: int) -> dict:
    """Milliseconds a unit of traced stretches with the spans and
    without, in turns."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    span, mark = profiling.span, profiling.mark
    times = {True: [], False: []}
    i = n + 1
    gc.collect()
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            if not on:
                profiling.span = lambda *_a, **_k: contextlib.nullcontext()
                profiling.mark = lambda *_a, **_k: None
            try:
                with profile(activities=acts):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        run(i)
                        i += 1
                    torch.cuda.synchronize()
                    times[on].append((time.perf_counter() - t0) * 1e3 / n)
            finally:
                profiling.span, profiling.mark = span, mark
            profiling.take()
            gc.collect()
    on_ms, off_ms = (statistics.median(times[k]) for k in (True, False))
    return {"on_ms": times[True], "off_ms": times[False],
            "median_on_ms": on_ms, "median_off_ms": off_ms,
            "cost_pct": 100.0 * (on_ms / off_ms - 1.0)}


def main(argv=None, cell=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", required=True)
    p.add_argument("--on-cost", type=int, default=0, metavar="R",
                   help="rounds of traced stretches with and without spans")
    args = p.parse_args(argv)
    cell = cell or harness.load_cell(args.workload)
    run, n = units_of(cell, args.seed,
                      "cuda" if torch.cuda.is_available() else "cpu")
    profiling.take()
    trace = traced(run, n)
    spans = profiling.take()
    by = collections.defaultdict(lambda: dict(device_ms=0.0, host_ms=0.0,
                                              count=0, syncs=0))
    for s in spans:
        row = by[s.name]
        row["device_ms"] += s.device_ms / n
        row["host_ms"] += s.host_ms / n
        row["count"] += 1 / n
        row["syncs"] += s.syncs / n
    layers = TRAIN_LAYERS if "train_step" in by else IMAGE_LAYERS
    out = {
        "cell": args.workload, "seed": args.seed, "units": n,
        "device": torch.cuda.get_device_name(0),
        "trace": trace, "spans": dict(by),
        "layers_ms": sum(by[k]["device_ms"] for k in layers if k in by),
        "syncs": sum(r["syncs"] for r in by.values()),
        "sync_sites": sync_sites(run, n),
    }
    if args.on_cost:
        out["on_cost"] = on_cost(run, n, args.on_cost)
    if "backward" in by:
        out["backward_ms"] = by["backward"]["device_ms"]
        out["parts_ms"] = sum(by[k]["device_ms"] for k in PARTS if k in by)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("cell", "layers_ms", "syncs")}
                     | {"window_ms": trace["window_ms"]}
                     | {k: out["on_cost"][k] for k in ("median_on_ms",
                                                       "median_off_ms",
                                                       "cost_pct")
                        if "on_cost" in out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
