#!/usr/bin/env python3
"""The DCN sampler backward's two designs, timed in turns on one NVIDIA GPU.

Both are in the package's ``csrc/dcn_sample_bwd.cu``: the point design (a
warp per point with float4 atomics into a canvas the caller zeroes, the
kernel's first design) and the tap design (canvas tiles summed in shared
memory, then a spill pass), chosen by its ``tiled`` argument. The script
checks both against the plain ``dcn_cuda.bilinear_sample_pix_bwd_plain``
(each output within 1e-5 of its largest magnitude, d_img as the f32
canvas) and times them at the three FeatureNet taps of the 512×640
training step (N = 4 views, C = 32; stage 3 at 512×640, stage 2 at
256×320, stage 1 at 128×160), f32 and bf16, points on the pixel grid plus
N(0, 1.5) offsets (``chip_smoke.dcn_case``). Each design is timed as a
wrapper calls it: the point design zeroes the canvas, launches with
``tiled`` = 0, and casts a bf16 canvas; the tap design is
``dcn_cuda.bilinear_sample_pix_bwd_kernel``. Device time: a CUDA graph of
50 calls replayed 5 times between CUDA events, in the turns point, tap,
tap, point. The share of corners that spill (``dcn_cuda
.spilled_corners``) and the tap design's phase stamps (the package's
source built with -DDCN_MARKS into ``build/lab/``, git-ignored) are
reported beside them.

Prints one JSON line per case and writes them to
``outputs/lab/dcn_bwd_variants.json`` (git-ignored). Not part of the
package and not run by the tests: ``chip_smoke.py`` is the check of the
kernel.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/dcn_bwd_variants.py
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (DCN_BWD_RTOL, dcn_bwd_errors,  # noqa: E402
                        dcn_case, device_time_ms)
from diner_tpu_torch.ops import cuda_build, dcn_cuda  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "dcn_bwd_variants.json"
TAPS = {"stage3": (512, 640), "stage2": (256, 320), "stage1": (128, 160)}
P = ctypes.c_void_p
PHASES = ("stage g, x, y, scale", "count", "scan", "list and sort",
          "pixel sums", "own points")


def build():
    """The package's launcher built with -DDCN_MARKS, and its stamp
    reader."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libdcn_bwd_marks.so"
    package = cuda_build.PKG_DIR / cuda_build.SOURCES["dcn_sample_bwd"]
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_build.NVCC_FLAGS,
                           "-DDCN_MARKS", "-o", str(lib), str(package)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode:
        raise RuntimeError(proc.stdout.decode())
    marked = ctypes.CDLL(str(lib))
    marked.dcn_sample_bwd.argtypes = dcn_cuda._ARGTYPES
    marked.dcn_sample_bwd.restype = ctypes.c_int
    marked.dcn_marks_read.argtypes = [P]
    marked.dcn_marks_read.restype = ctypes.c_int
    return marked


def phase_stamps(marked, img, x, y, scale, g):
    """The tile kernel's phases at one call: mean µs of each, a block's
    mean life in µs and the blocks resident at once (their summed life
    over the kernel's span)."""
    N, H, W, C = img.shape
    acc = torch.empty((N * H * W, C), dtype=torch.float32, device="cuda")
    d = [torch.empty((N, H * W), device="cuda") for _ in range(3)]
    for _ in range(3):
        err = cuda_build.launch(
            marked.dcn_sample_bwd, img.device, img.data_ptr(), x.data_ptr(),
            y.data_ptr(), scale.data_ptr(), g.data_ptr(), acc.data_ptr(),
            *(t.data_ptr() for t in d), N, H, W, C, H * W,
            img.element_size(), 1)
        if err:
            raise RuntimeError(f"marked build: CUDA error {err}")
    torch.cuda.synchronize()
    host = np.zeros((1 << 16, 8), dtype=np.uint64)
    if marked.dcn_marks_read(host.ctypes.data):
        raise RuntimeError("dcn_marks_read failed")
    blocks = -(-W // dcn_cuda.TILE_W) * -(-H // dcn_cuda.TILE_H) * N
    m = host[:blocks, :7].astype(np.int64)
    life = m[:, 6] - m[:, 0]
    span = m[:, 6].max() - m[:, 0].min()
    return {"phases_us": dict(zip(PHASES, (np.diff(m, axis=1).mean(0)
                                            / 1e3).tolist())),
            "block_life_us": float(life.mean()) / 1e3,
            "blocks_resident": float(life.sum() / span)}


def point_call(img, x, y, scale, g, f32_d_img=False):
    """The package's point design as a wrapper calls it: zero the canvas,
    launch with ``tiled`` = 0, cast it once."""
    N, H, W, C = img.shape
    P_ = x.shape[1]
    acc = torch.zeros((N * H * W, C), dtype=torch.float32, device=img.device)
    d_x = torch.empty((N, P_), dtype=torch.float32, device=img.device)
    d_y = torch.empty_like(d_x)
    d_s = torch.empty_like(d_x) if scale is not None else None
    err = cuda_build.launch(
        dcn_cuda._launcher(), img.device, img.data_ptr(), x.data_ptr(),
        y.data_ptr(), scale.data_ptr() if scale is not None else None,
        g.data_ptr(), acc.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
        d_s.data_ptr() if d_s is not None else None, N, H, W, C, P_,
        img.element_size(), 0)
    if err:
        raise RuntimeError(f"point design: CUDA error {err}")
    d_img = acc.reshape(N, H, W, C)
    return (d_img if f32_d_img else d_img.to(img.dtype)), d_x, d_y, d_s


def main():
    if not torch.cuda.is_available():
        raise SystemExit("dcn_bwd_variants: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    marked = build()
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0}),
          flush=True)
    rows, bad = [], []
    for tap, (H, W) in TAPS.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = dcn_case(4, H, W, 32, H * W, dtype, True, seed=50,
                            edges=False)
            ref = dcn_cuda.bilinear_sample_pix_bwd_plain(*args,
                                                         f32_d_img=True)
            fns = {"point": lambda: point_call(*args),  # noqa: B023
                   "tap": lambda: dcn_cuda  # noqa: B023
                   .bilinear_sample_pix_bwd_kernel(*args)}
            row = {"case": tap, "H": H, "W": W, "C": 32, "N": 4,
                   "dtype": str(dtype), "device": smi}
            got = {"point": point_call(*args, f32_d_img=True),
                   "tap": dcn_cuda.bilinear_sample_pix_bwd_kernel(
                       *args, f32_d_img=True)}
            torch.cuda.synchronize()
            for name, out in got.items():
                errs = dcn_bwd_errors(out, ref)
                row[name] = {"errs": errs}
                if max(errs) > DCN_BWD_RTOL:
                    bad.append((tap, str(dtype), name, errs))
            del got, ref
            spills = dcn_cuda.spilled_corners(args[0].shape, *args[1:3])
            valid = [c[2] for c in dcn_cuda.corner_meta(
                args[0].shape, *args[1:3], None)[0]]
            row["spill_share"] = (sum(int(s.sum()) for s in spills)
                                  / sum(int(v.sum()) for v in valid))
            turns = []
            for name in ("point", "tap", "tap", "point"):
                ms = device_time_ms(fns[name])
                turns.append([name, ms])
                row[name].setdefault("ms", []).append(ms)
            row["turns"] = turns
            row["marks"] = phase_stamps(marked, *args)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del args
            torch.cuda.empty_cache()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    if bad:
        raise SystemExit(f"dcn_bwd_variants: outputs differ: {bad}")


if __name__ == "__main__":
    main()
