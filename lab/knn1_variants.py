#!/usr/bin/env python3
"""Design variants of the top-1 kNN kernel, timed on one NVIDIA GPU.

Builds ``lab/knn1_variants.cu`` (which includes the package's
``csrc/knn1.cu``) with ``nvcc`` into ``build/lab/`` (git-ignored), checks
every variant against the plain ``knn_cuda.knn1_plain`` (indices equal) at
the NOVEL step's shapes on FaceScape's 26,317 vertices and at
``chip_smoke.knn_edge_cases``' non-finite cases, and times each at the
NOVEL step's shapes (device time: a CUDA graph of 5 calls, replayed 3
times between CUDA events). Variants: the package's launcher (the
NaN-aware compare only on tiles where a NaN can arise), the NaN-aware
compare on every pair, and the strict ``d2 < best`` on every pair (a NaN
never wins: not ``argmin``'s rule, so it is expected to differ on the
non-finite cases).

Prints one JSON line per case and writes them to
``outputs/lab/knn1_variants.json`` (git-ignored). Not part of the package
and not run by the tests: ``chip_smoke.py`` is the check of the kernel.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/knn1_variants.py
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import KNN_V, device_time_ms, knn_edge_cases  # noqa: E402
from diner_tpu_torch.data.synthetic_dataset import SphereDataset  # noqa
from diner_tpu_torch.ops import cuda_build, knn_cuda  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "knn1_variants.json"
VARIANTS = {"package": 0, "nan_check_every_pair": 1, "strict_less": 2}


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libknn1_variants.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_build.NVCC_FLAGS,
                    "-o", str(lib), str(ROOT / "lab" / "knn1_variants.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).lab
    fn.argtypes = [ctypes.c_int, *knn_cuda._ARGTYPES]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        raise SystemExit("knn1_variants: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lab = build()
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0}),
          flush=True)

    def run(v, p, verts):
        out = torch.empty(p.shape[:2], dtype=torch.int32, device="cuda")
        err = cuda_build.launch(lab, p.device, v, p.data_ptr(),
                                verts.data_ptr(), out.data_ptr(),
                                p.shape[1], verts.shape[1], p.shape[0])
        if err:
            raise RuntimeError(f"variant {v}: CUDA error {err}")
        return out

    g = torch.Generator(device="cuda").manual_seed(9)
    verts = torch.from_numpy(SphereDataset._surface_points(KNN_V, 0))[
        None].cuda()
    cases = {name: (p, v, True) for name, (p, v, _) in
             knn_edge_cases("cuda").items()
             if name in ("nan_inputs", "nonfinite_tiles")}
    for name, n in (("sampler", 4096 * 1000), ("deform", 4096 * 40)):
        cases[name] = (torch.rand((1, n, 3), generator=g, device="cuda")
                       * 1.2 - 0.6, verts, False)
    rows, bad = [], []
    for name, (p, v, nonfinite) in cases.items():
        ref = knn_cuda.knn1_plain(p, v)
        row = {"case": name, "N": p.shape[1], "V": v.shape[1],
               "device": smi}
        for vname, idx in VARIANTS.items():
            got = run(idx, p, v)
            torch.cuda.synchronize()
            r = {"index_disagreements": int((got != ref).sum())}
            if not nonfinite:
                r["ms"] = device_time_ms(lambda: run(idx, p, v), n=5,
                                         replays=3)
            row[vname] = r
            if r["index_disagreements"] and vname != "strict_less":
                bad.append((name, vname))
        print(json.dumps(row), flush=True)
        rows.append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    if bad:
        raise SystemExit(f"knn1_variants: indices differ: {bad}")


if __name__ == "__main__":
    main()
