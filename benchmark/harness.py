"""What every driver shares: finding a cell's files by name, seeds, the
device's description, the profiler's reduction, the per-layer readers and
the comparison that decides ``correct``."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import statistics
import time
from dataclasses import dataclass
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SEED_MOD = 2 ** 63 - 1
# the second witness of a look at bfloat16 readings: the reference in it
WITNESS = {"compute_dtype": "bfloat16"}


def sub_seed(seed: int, stream: int) -> int:
    """An independent generator seed for ``stream`` of run ``seed``."""
    return (int(seed) * 1_000_003 + stream * 7_919 + 12_345) % SEED_MOD


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # benchmark/configs/<config>.json
    traffic: dict        # benchmark/traffic/<traffic>.json
    settings: dict       # benchmark/workloads/<cell>.json
    bench: dict          # BENCHMARK.json

    @property
    def limits(self) -> dict:
        """The numbers ``correct`` compares, each with its limit."""
        return self.settings["limits"]

    @property
    def family(self):
        return importlib.import_module(
            f"benchmark.families.{self.config['family']}")

    @property
    def driver(self):
        return importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}")

    def metrics(self, section: str) -> list:
        """The cell's metrics of ``section`` ("end_to_end", "per_layer")."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]


def workload_names() -> list:
    """Every cell of ``BENCHMARK.json``, in its order."""
    return [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    wl = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return Cell(name=name, entry=entry,
                config=load_json(BENCH_DIR / "configs"
                                 / f"{entry['config']}.json"),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json"),
                settings=wl, bench=bench)


def peaks() -> dict:
    return load_json(BENCH_DIR / "peaks.json")


def set_tf32(cell: Cell):
    """TF32 for matrix products and convolutions as the configuration
    states."""
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    torch.backends.cudnn.allow_tf32 = cell.config["tf32"]


def free():
    """Return what the freed objects held on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


class Window:
    """Host-clock window that closes when the work in flight completes."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0


def span_ms(fn, runs: int = 3) -> float:
    """Median device-side milliseconds of ``fn`` between CUDA events,
    after one warm call."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- trace

def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, n: int) -> dict:
    """Run ``fn(i)`` for i < n under ``torch.profiler`` and reduce the
    trace: device ops and their intervals, busy time as the union of the
    intervals, the window from the first call to the last device op's end,
    the device's idle gaps and what the host did in each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        with record_function("bench.window"):
            for i in range(n):
                with record_function("bench.unit"):
                    fn(i)
            torch.cuda.synchronize()
    events = prof.events()
    # device ops: kernels, copies and fills; not the annotations' ranges
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("bench.")]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    win = next(e for e in host if e.name == "bench.window")
    start = win.time_range.start
    end = max([win.time_range.end] + [e.time_range.end for e in dev])
    busy = _union([(max(e.time_range.start, start), e.time_range.end)
                   for e in dev if e.time_range.end > start])
    busy_us = sum(e - s for s, e in busy)
    gaps = [(s, e) for (_, s), (e, _) in zip(
        [[start, start]] + busy, busy + [[end, end]]) if e > s]
    by_op = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    others = [e for e in host if not e.name.startswith("bench.")]
    idle = []
    for s, e in longest:
        over = [(min(e, h.time_range.end) - max(s, h.time_range.start),
                 -h.time_range.elapsed_us(), h.name) for h in others]
        o, _, name = max(over, default=(0, 0, "host"))
        idle.append([name if o > 0 else "host", (e - s) / 1e6])
    return {
        "window_s": (end - start) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in top_ops],
        "idle_gaps": idle,
        "kernel_s": {k: v / 1e6 for k, v in by_op.items()},
        "kernels": sum(1 for e in dev
                       if not e.name.startswith(("Memcpy", "Memset"))),
    }


def kernel_seconds(trace: dict, names) -> float:
    """Device seconds of the ops whose names hold any of ``names``."""
    return sum(v for k, v in trace["kernel_s"].items()
               if any(n in k for n in names))


# ---------------------------------------------------------------- readers

def read_per_layer(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader,
    ``benchmark/metrics/<name>.py``'s ``read(ctx)``; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for m in cell.metrics("per_layer"):
        path = BENCH_DIR / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------- checks

def worst_leaf_gap(prog: dict, ref: dict, names=None):
    """(gap, leaf): the largest |‖program‖ − ‖reference‖| of a leaf over
    the larger of the reference's norm of that leaf and of the median
    leaf. ``prog`` and ``ref`` map leaf names to norms."""
    names = sorted(ref) if names is None else sorted(names)
    med = statistics.median(ref[n] for n in ref)
    worst = (0.0, "")
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        worst = max(worst, (gap, n))
    return worst


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median over leaves of |‖program‖ − ‖reference‖| over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in ref)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                             for n in ref)


def verdict(readings: dict, limits: dict):
    """(correct, checks): each number that ``limits`` names beside its
    limit; correct when each of them is finite and within it."""
    ok, checks = True, {}
    for k, lim in limits.items():
        v = readings[k]
        ok &= v == v and abs(v) != float("inf") and v <= lim
        checks[k] = {"value": v, "limit": lim}
    return ok, checks
