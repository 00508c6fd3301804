#!/usr/bin/env python3
"""The MVS training step of two checkouts, timed in turns on one NVIDIA GPU.

``python3 lab/mvs_step_turns.py OTHER_ROOT`` writes the DTU fixture once
(``chip_smoke.phase_mvs_fixture``), then runs the step of OTHER_ROOT (for
example an unpacked ``git archive`` of the parent commit) and of this
checkout in the turns other, this, this, other, each in a process of its
own started in its root (so each builds and loads its own kernels). A turn
takes TransMVSNet at the training CLI's defaults (``MVSTrainConfig``:
512×640, 5 views, batch 1) in f32 and then in bf16: 2 warm-up steps, then
``--steps`` steps each timed between CUDA events
(``utils/profiling.py:time_fn``), TF32 off as in ``chip_smoke.py``.

Prints one JSON line per turn and writes them to
``outputs/lab/mvs_step_turns.json`` (git-ignored). Not part of the package
and not run by the tests.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/mvs_step_turns.py OTHER_ROOT [--steps 5]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "outputs" / "lab" / "mvs_step_turns.json"
TAG = "mvs_step_turn="

# one turn, run with the checkout's root as its working directory and first
# on sys.path; argv: fixture directory, timed steps
TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from pathlib import Path
from diner_tpu_torch.data.loader import collate
from diner_tpu_torch.mvs.datasets import MVSDTUDataset
from diner_tpu_torch.mvs.train import (MVSTrainConfig, batch_to_device,
                                       create_mvs_state, make_mvs_train_step)
from diner_tpu_torch.utils.profiling import time_fn
fixture, steps = Path(sys.argv[1]), int(sys.argv[2])
ds = MVSDTUDataset(fixture, fixture / "list.txt", "train")
batch = batch_to_device(collate([ds[0]]), "cuda")
out = {}
for dtype in ("float32", "bfloat16"):
    cfg = MVSTrainConfig(compute_dtype=dtype)
    state = create_mvs_state(cfg, seed=0, device="cuda")
    step = make_mvs_train_step(state, cfg)
    out[dtype] = time_fn(step, batch, warmup=2, iters=steps)
    del state, step
    torch.cuda.empty_cache()
print(TAG + json.dumps(out))
""".replace("TAG", repr(TAG))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mvs_step_turns: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    chip_smoke.phase_mvs_fixture()
    roots = {"other": args.other.resolve(), "this": ROOT}
    rows = []
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, "-c", TURN, str(chip_smoke.MVS_FIXTURE),
             str(args.steps)], cwd=roots[name], capture_output=True,
            text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
        if proc.returncode or not lines:
            raise SystemExit(f"turn {name} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
        row = dict(turn=name, root=str(roots[name]), device=smi,
                   **json.loads(lines[-1][len(TAG):]))
        print(json.dumps(row), flush=True)
        rows.append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
