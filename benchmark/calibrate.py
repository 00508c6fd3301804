"""Readings the comparison limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--witness] [--faults] [--dump]

For each seed: the program's readings against the reference (what a run
compares once its window has closed, without the window: a training
cell's first three steps, a render cell's first image); with
``--control`` the control's, the reference in the configuration's control
precision put in the program's place; with ``--witness`` the reference's
in bfloat16 (a second witness for a look at bfloat16 readings); with
``--faults`` the program's with each of the cell's faults planted
(each traffic driver's ``FAULTS``). One JSON line a seed. Each traffic
driver reads its cells' numbers in its own ``calibrate``. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    for flag in ("control", "witness", "faults", "dump"):
        p.add_argument(f"--{flag}", action="store_true")
    opts = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    cell = harness.load_cell(opts.workload)
    for seed in (int(s) for s in opts.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell.driver.calibrate(cell, seed, opts)
        print(json.dumps({"workload": opts.workload, "seed": seed, **r,
                          "limits": cell.limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
