#!/usr/bin/env python3
"""Design variants of kernel B, the compositing backward, timed on one
NVIDIA GPU.

Builds ``lab/composite_bwd_variants.cu`` (which includes the package's
``csrc/composite_bwd.cu``) with ``nvcc`` into ``build/lab/`` (git-ignored),
then, for each case, checks every variant against the plain
``composite_bwd`` (d_rgb within 1e-5, d_sigma within 1e-5 of its largest
value, the errors recorded) and times its device time (50 launches captured
in one CUDA graph, replayed between CUDA events, over 50) beside the
package's wrapper and the plain version. Variants: the package's launcher
(half a warp per ray where 16-sample chunks pad K less, else a warp), a
warp or half a warp per ray with K <= 64 in registers, either one with T
at chunk starts in shared memory at every K, and the first kernel B's
thread per ray (S_k = total - prefix_k). The saturated cases
(``chip_smoke.saturate``: samples at alpha ~ 1) show each variant's d_sigma
error where the 1e-10 floor divides S_k.

Prints one JSON line per case and writes them all to
``outputs/lab/composite_bwd_variants.json`` (git-ignored). Not part of the
package and not run by the tests: ``chip_smoke.py`` is the check of the
kernel itself.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/composite_bwd_variants.py
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
from chip_smoke import device_time_ms, field_case, saturate  # noqa: E402
from diner_tpu_torch.ops import composite as plain  # noqa: E402
from diner_tpu_torch.ops import composite_cuda  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "composite_bwd_variants.json"
VARIANTS = {"package": 0, "warp_regs": 1, "half_warp_regs": 2,
            "warp_shared": 3, "half_warp_shared": 4, "thread_per_ray": 5}
# (R, K, g_depth and g_w, saturated): the train step (one 64×64 patch, and
# the train loop's batch of two), the eval shape, the cotangents of the full
# VJP, a K past the register path, and K = 33 and 1, where half a warp pads
# less; then the train step's and K = 100 with samples at alpha ~ 1
CASES = ((4096, 40, False, False), (8192, 40, False, False),
         (4096, 64, False, False), (4096, 40, True, False),
         (4096, 100, False, False), (4096, 33, False, False),
         (4096, 1, False, False), (4096, 40, False, True),
         (4096, 100, False, True))


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libcomposite_bwd_variants.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I",
                    str(ROOT / "diner_tpu_torch" / "csrc"), "-o", str(lib),
                    str(ROOT / "lab" / "composite_bwd_variants.cu")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).lab
    P_, L_, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I_, P_, L_, L_, L_, P_, L_, L_, P_, L_, L_, P_, L_,
                   P_, L_, L_, P_, L_, P_, L_, L_, P_, P_, I_, I_, I_, P_]
    fn.restype = I_
    return fn


def main():
    if not torch.cuda.is_available():
        raise SystemExit("composite_bwd_variants: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lab = build()
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0}),
          flush=True)

    rows = []
    for R, K, full, saturated in CASES:
        rgb, sigma, z, rays = field_case(R, K, R + K)
        g = torch.Generator(device="cuda").manual_seed(K)
        if saturated:
            saturate(sigma, z, rays[..., 7], g)
        g_rgb = torch.randn((1, R, 3), generator=g, device="cuda")
        g_depth = torch.randn((1, R), generator=g, device="cuda") if full \
            else None
        g_w = torch.randn((1, R, K), generator=g, device="cuda") if full \
            else None
        c, s, zz = rgb.view(R, K, 3), sigma.view(R, K), z.view(R, K)
        far = rays[..., 7].view(R)
        gr = g_rgb.view(R, 3)

        def variant(v):
            d_rgb = torch.empty((R, K, 3), device="cuda")
            d_sigma = torch.empty((R, K), device="cuda")
            err = lab(v, c.data_ptr(), *c.stride(), s.data_ptr(),
                      *s.stride(), zz.data_ptr(), *zz.stride(),
                      far.data_ptr(), far.stride(0), gr.data_ptr(),
                      *gr.stride(),
                      None if g_depth is None else g_depth.data_ptr(),
                      0 if g_depth is None else 1,
                      None if g_w is None else g_w.data_ptr(),
                      *((0, 0) if g_w is None else (K, 1)),
                      d_rgb.data_ptr(), d_sigma.data_ptr(), R, K, 0,
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {v}: CUDA error {err}")
            return d_rgb, d_sigma

        ref = plain.composite_bwd(rgb, sigma, z, rays[..., 7], g_rgb,
                                  g_depth, g_w)
        scale = float(ref[1].abs().max())
        row = {"R": R, "K": K, "g_depth_and_g_w": full,
               "saturated": saturated, "device": smi,
               "plain_ms": device_time_ms(lambda: plain.composite_bwd(
                   rgb, sigma, z, rays[..., 7], g_rgb, g_depth, g_w)),
               "package_wrapper_ms": device_time_ms(
                   lambda: composite_cuda.composite_bwd_kernel(
                       rgb, sigma, z, rays, g_rgb, g_depth, g_w)),
               "d_sigma_scale": scale}
        for name, v in VARIANTS.items():
            d_rgb, d_sigma = variant(v)
            torch.cuda.synchronize()
            err_rgb = float((d_rgb.view_as(ref[0]) - ref[0]).abs().max())
            err_sigma = float((d_sigma.view_as(ref[1]) - ref[1]).abs().max())
            row[name] = {"ms": device_time_ms(lambda: variant(v)),
                         "err_d_rgb": err_rgb, "err_d_sigma": err_sigma,
                         "err_d_sigma_over_scale": err_sigma / scale,
                         "ok": err_rgb <= 1e-5 and err_sigma <= 1e-5 * scale}
        print(json.dumps(row), flush=True)
        rows.append(row)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    bad = [(r["R"], r["K"], n) for r in rows for n in VARIANTS
           if not r[n]["ok"] and n != "thread_per_ray"]
    if bad:
        raise SystemExit(f"composite_bwd_variants: outside tolerance: {bad}")


if __name__ == "__main__":
    main()
