"""Which device kernels each of the field's matrix products runs, read from
one traced unit of a benchmark cell.

Builds the cell's program and runs its warm-up as ``lab/step_spans.py``
does, names every ``Dense`` of the model by its module path, and traces one
unit (a train step or an image) under ``torch.profiler`` with each
``Dense`` call inside a ``record_function`` of its name. Writes as JSON:

- every device kernel by (kernel, the aten op that launched it, its
  scope): its device ms and launches. The scope is the innermost ``Dense``
  or program span around the op; in the backward, the ``Dense`` whose
  forward made the autograd node (by the node's sequence number), with
  ``.bwd`` appended, or the node's name;
- by scope, the device ms of matrix products and of all else;
- ``nn/resnetfc.py``'s ``misaligned`` count over the unit, where the
  program has one.

    python3 lab/field_products.py --workload diner_dtu.render --seed 7 \\
        --out outputs/products.diner_dtu.render.json

Not part of the package or the benchmark.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from diner_tpu_torch.models.pixelnerf import PixelNeRF  # noqa: E402
from diner_tpu_torch.nn import resnetfc  # noqa: E402
from step_spans import SPANS, units_of  # noqa: E402

NODE = "autograd::engine::evaluate_function: "
GEMM = ("gemm", "nvjet", "xmma", "cutlass")


def label_dense():
    """Name every Dense of every PixelNeRF alive by its module path."""
    for obj in gc.get_objects():
        if isinstance(obj, PixelNeRF):
            for name, m in obj.named_modules():
                if isinstance(m, resnetfc.Dense):
                    m.lab_name = name


def traced_dense(run):
    """Run one unit with each Dense call in a ``dense.<name>`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    forward = resnetfc.Dense.forward

    def named(self, x):
        with record_function("dense." + getattr(self, "lab_name", "?")):
            return forward(self, x)

    resnetfc.Dense.forward = named
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(0)
            torch.cuda.synchronize()
    finally:
        resnetfc.Dense.forward = forward
    return prof.events()


def scope_of(e, seq_dense):
    p = e
    while p is not None:
        if p.name.startswith("dense."):
            return p.name[len("dense."):]
        if p.name.startswith(NODE):
            dense = seq_dense.get(p.sequence_nr)
            return dense + ".bwd" if dense else p.name[len(NODE):]
        if p.name in SPANS:
            return p.name
        p = p.cpu_parent
    return "host"


def kernel_rows(events):
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    seq_dense = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(NODE):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("dense."):
                p = p.cpu_parent
            if p is not None:
                seq_dense.setdefault(e.sequence_nr, p.name[len("dense."):])
    rows = collections.defaultdict(lambda: [0.0, 0])
    for e in cpu:
        for k in e.kernels:
            row = rows[(k.name, e.name, scope_of(e, seq_dense))]
            row[0] += k.duration / 1e3
            row[1] += 1
    return sorted(([k, op, scope, ms, n]
                   for (k, op, scope), (ms, n) in rows.items()),
                  key=lambda r: -r[3])


def main(argv=None, cell=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = cell or harness.load_cell(args.workload)
    run, _ = units_of(cell, args.seed)
    label_dense()
    before = getattr(resnetfc, "misaligned", None)
    rows = kernel_rows(traced_dense(run))
    after = getattr(resnetfc, "misaligned", None)
    by_scope = collections.defaultdict(lambda: {"gemm_ms": 0.0,
                                                "other_ms": 0.0})
    for k, _, scope, ms, _ in rows:
        kind = "gemm_ms" if any(g in k for g in GEMM) else "other_ms"
        by_scope[scope][kind] += ms
    out = {
        "cell": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "misaligned": None if before is None else after - before,
        "align1_ms": sum(r[3] for r in rows if "align1" in r[0]),
        "by_scope": dict(sorted(by_scope.items(),
                                key=lambda kv: -sum(kv[1].values()))),
        "kernels": rows,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("cell", "misaligned",
                                          "align1_ms")}))
    for k, op, scope, ms, n in rows[:30]:
        print(f"{ms:10.3f} ms {n:6d}  {scope:24s} {op:28s} {k[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
