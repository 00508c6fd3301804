"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic, comparison limits and per-layer readers are
files under ``benchmark/`` found by name. With ``--trace 0`` the last line
of standard output is the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics; both carry ``correct`` and the numbers compared,
which also end standard error. The program's kernels build into
``build/`` inside the checkout on the first run there.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diner_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``diner_tpu_torch`` is not ``diner_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the run writes stays inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import diner_tpu_torch  # noqa: F401  (fails where the program is absent)
    torch.cuda.reset_peak_memory_stats()
    res = cell.driver.run(cell, args, T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    correct, checks = harness.verdict(res["readings"], cell.limits)
    correct = correct and res["failed"] == 0 and res["attempted"] > 0
    device = dict(harness.device_info(chips),
                  memory_peak_bytes=int(res["peak"]))
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"]}
    if args.trace:
        ctx = res["trace_ctx"]
        line["metrics"] = harness.read_per_layer(cell, ctx)
        device.update(busy_s=ctx["trace"]["busy_s"],
                      window_s=ctx["trace"]["window_s"])
        line["device"] = device
        line["breakdown"] = {k: ctx["trace"][k]
                             for k in ("device_ops", "idle_gaps")}
    else:
        units = {m["name"]: m["unit"] for m in cell.metrics("end_to_end")}
        line["metrics"] = {k: {"value": v, "unit": units[k]}
                           for k, v in res["out"].items()}
        line["device"] = device
    line["readings"] = {k: v for k, v in res["readings"].items()
                        if k not in checks}
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
