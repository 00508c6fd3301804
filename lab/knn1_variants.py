#!/usr/bin/env python3
"""The top-1 kNN kernel's designs, timed in turns on one NVIDIA GPU.

Builds ``lab/knn1_variants.cu`` (the package's ``csrc/knn1.cu``, the tile
cull, with the first, brute-force design beside it) with ``nvcc`` into
``build/lab/`` (git-ignored), checks every variant against the plain
``knn_cuda.knn1_plain`` (indices equal) on FaceScape's 26,317 vertices and
on ``chip_smoke.knn_edge_cases``' non-finite and mirrored-tie cases, and
times them at the NOVEL step's shapes: the sampler's 4,096 rays × 1,000
candidates and ``deform_points``' 4,096 × 40 samples, each on ray-ordered
points as the path makes them (``chip_smoke.knn_ray_points``) and uniform
in a cube. Device time: a CUDA graph of 5 calls, replayed 3 times between
CUDA events. The turns are brute force, package, package, brute force,
where "package" is the wrapper ``knn_cuda.knn1_kernel`` (the tile plan's
tensor ops and the kernel); the kernel alone on a ready plan, the plan
alone, the share of tiles culled and the brute-force design's NaN
variants (the NaN-aware compare on every pair; the strict ``d2 < best``,
which is expected to differ on the non-finite cases) follow.

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
from chip_smoke import (KNN_SAMPLES, device_time_ms,  # noqa: E402
                        knn_edge_cases, knn_ray_points)
from diner_tpu_torch.ops import cuda_build, knn_cuda  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "knn1_variants.json"
VARIANTS = {"package_kernel": 0, "brute_force": 1,
            "brute_force_nan_check_every_pair": 2,
            "brute_force_strict_less": 3}
P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libknn1_variants.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_build.NVCC_FLAGS,
                    "-o", str(lib), str(ROOT / "lab" / "knn1_variants.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).lab
    fn.argtypes = [I, P, P, P, P, P, P, P, L, I, I, I, I, P]
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

    def runner(variant, p, verts):
        plan = knn_cuda.tile_plan(verts)

        def run():
            out = torch.empty(p.shape[:2], dtype=torch.int32, device="cuda")
            err = cuda_build.launch(
                lab, p.device, variant, p.data_ptr(), verts.data_ptr(),
                plan["verts"].data_ptr(), plan["vidx"].data_ptr(),
                plan["boxes"].data_ptr(), plan["reps"].data_ptr(),
                out.data_ptr(), p.shape[1], verts.shape[1], knn_cuda.TILE,
                plan["reps"].shape[1], p.shape[0])
            if err:
                raise RuntimeError(f"variant {variant}: CUDA error {err}")
            return out
        return run

    ray, verts = knn_ray_points("cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = {name: (p, v, False) for name, (p, v, _) in
             knn_edge_cases("cuda").items()
             if name in ("nan_inputs", "nonfinite_tiles", "mirror_ties")}
    cases["render_chunk"] = (ray, verts, True)
    cases["sampler"] = (torch.rand(ray.shape, generator=g, device="cuda")
                        * 1.2 - 0.6, verts, True)
    deform_rays = knn_ray_points("cuda", n_cand=KNN_SAMPLES, seed=10)[0]
    cases["deform_rays"] = (deform_rays, verts, True)
    cases["deform"] = (torch.rand(deform_rays.shape, generator=g,
                                  device="cuda") * 1.2 - 0.6, verts, True)
    rows, bad = [], []
    for name, (p, v, timed) in cases.items():
        ref = knn_cuda.knn1_plain(p, v)
        row = {"case": name, "N": p.shape[1], "V": v.shape[1],
               "device": smi}
        fns = {vname: runner(idx, p, v) for vname, idx in VARIANTS.items()}
        fns["package"] = lambda: knn_cuda.knn1_kernel(p, v)  # noqa: B023
        fns["plan"] = lambda: knn_cuda.tile_plan(v)  # noqa: B023
        for vname, fn in fns.items():
            if vname == "plan":
                continue
            got = fn()
            torch.cuda.synchronize()
            n_diff = int((got != ref).sum())
            row[vname] = {"index_disagreements": n_diff}
            if n_diff and not (vname == "brute_force_strict_less"
                               and name in ("nan_inputs", "nonfinite_tiles")):
                bad.append((name, vname))
        if timed:
            _, row["tiles_culled"] = knn_cuda.knn1_kernel_culled(p, v)
            turns = []
            for vname in ("brute_force", "package", "package", "brute_force",
                          "package_kernel", "plan",
                          "brute_force_nan_check_every_pair",
                          "brute_force_strict_less"):
                ms = device_time_ms(fns[vname], n=5, replays=3)
                turns.append([vname, ms])
                row.setdefault(vname, {}).setdefault("ms", []).append(ms)
            row["turns"] = turns
        print(json.dumps(row), flush=True)
        rows.append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    if bad:
        raise SystemExit(f"knn1_variants: indices differ: {bad}")


if __name__ == "__main__":
    main()
