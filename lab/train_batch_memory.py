#!/usr/bin/env python3
"""Peak device memory and time of the production train step in f32 by the
number of scenes per step, on one NVIDIA GPU.

``configs/train_dtu.yaml``'s recipe as the port reads it (ResNet34,
ResnetFC 5×512, 40 samples from 1000 candidates, a 64×64 patch per scene,
MSE + 0.1·VGG + 1.0·antibias, f32: the config sets no compute dtype) on the
analytic sphere at 512×640 with 4 source views, at 1, 2 and 4 scenes per
step: one warm-up step, then three timed (host clock with a synchronize),
with ``torch.cuda.max_memory_allocated`` over the timed steps. A batch that
does not fit is reported as out of memory. This is how ``chip_smoke.py``'s
``train_loop`` phase chose 2 scenes per step under its 40 GB limit.

Prints one JSON line per batch size and writes them to
``outputs/lab/train_batch_memory.json`` (git-ignored). Run from the
repository root on a machine with a GPU:  python3 lab/train_batch_memory.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from diner_tpu_torch.data.synthetic import make_sphere_scene  # noqa: E402
from diner_tpu_torch.losses import init_vgg19  # noqa: E402
from diner_tpu_torch.train.config import load_train_config  # noqa: E402
from diner_tpu_torch.train.diner import (batch_to_device,  # noqa: E402
                                         create_model, make_train_step)

OUT = ROOT / "outputs" / "lab" / "train_batch_memory.json"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_batch_memory: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = load_train_config(ROOT / "configs" / "train_dtu.yaml").diner
    one = make_sphere_scene(H=512, W=640, nv=4)
    vgg = init_vgg19(0, device="cuda")
    rows = []
    for sb in (1, 2, 4):
        b = batch_to_device({k: np.repeat(v, sb, axis=0)
                             for k, v in one.items()}, "cuda")
        row = {"scenes_per_step": sb, "compute_dtype": cfg.nerf.compute_dtype,
               "rays_per_step": sb * cfg.rays_per_step, "device": smi}
        try:
            step = make_train_step(create_model(cfg, b, seed=0), cfg, vgg)
            gen = torch.Generator(device="cuda").manual_seed(0)
            step(b, generator=gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(b, generator=gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row.update(s_per_step=times,
                       peak_mem_bytes=torch.cuda.max_memory_allocated())
            del step
        except torch.cuda.OutOfMemoryError as e:
            row["out_of_memory"] = str(e).splitlines()[0]
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
