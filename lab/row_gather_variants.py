#!/usr/bin/env python3
"""Design variants of kernel C, the row gather, timed on one NVIDIA GPU.

Builds ``lab/row_gather_variants.cu`` with ``nvcc`` into
``build/lab/`` (git-ignored), then times each variant's device time (50
launches captured in one CUDA graph, replayed between CUDA events, over
50) beside ``index_select`` and the package's kernel C on the same inputs,
after checking that it equals ``index_select`` bit for bit. The inputs are
the path's gather shapes with int64 indices: uniform random rows, rows
drawn from a window as small as one render chunk touches (L2-resident),
and, for the depth map, neighbouring lookups on neighbouring rows.

Prints one JSON line per case and writes them all to
``outputs/lab/row_gather_variants.json`` (git-ignored). Not part of the package and
not run by the tests: ``chip_smoke.py`` is the check of the kernel itself.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/row_gather_variants.py
"""

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from diner_tpu_torch.ops import gather_cuda  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "row_gather_variants.json"

# (R, C, dtype, P, window): window None = uniform over the table, an int =
# uniform over that many rows, -1 = P // 16 + [0, 64) (neighbouring rows)
CASES = {
    "corner_random": (491520, 512, torch.bfloat16, 1048576, None),
    "corner_window": (491520, 512, torch.bfloat16, 1048576, 21900),
    "pair_random": (491520, 1024, torch.bfloat16, 1048576, None),
    "lab_proxy_c128_f32": (1310720, 128, torch.float32, 512000, None),
    "map_random": (1310720, 5, torch.float32, 16384000, None),
    "map_window": (1310720, 5, torch.float32, 16384000, 600000),
    "map_pruned_stage": (1310720, 5, torch.float32, 2097152, None),
    "depth_random": (1310720, 1, torch.float32, 1048576, None),
    "depth_window": (1310720, 1, torch.float32, 1048576, 54000),
    "depth_coherent": (1310720, 1, torch.float32, 1048576, -1),
}

# name: (variant, nc, cs, kb) as the .cu's lab() takes them
WIDE = {
    "persistent_nc_cs": (0, 1, 1, 8), "persistent_ldg_cs": (0, 0, 1, 8),
    "oneshot_nc_cs": (1, 1, 1, 8), "oneshot_ldg_cs_ld2": (1, 0, 1, 2),
    "oneshot_ldg_cs_ld4": (1, 0, 1, 4),
    "oneshot_ldg_cs_ld8": (1, 0, 1, 8), "oneshot_ldg_cs_ld16": (1, 0, 1, 16),
    "oneshot_ldg_st_ld8": (1, 0, 0, 8), "oneshot_pf256_cs_ld8": (1, 2, 1, 8),
    "oneshot_pf128_cs_ld8": (1, 3, 1, 8), "blockrow_ldg_cs": (2, 0, 1, 0),
    "blockrow_ldg_st": (2, 0, 0, 0),
}
NARROW = {
    "lane_row_nc_cs": (30, 1, 1, 0), "lane_row_ldg_cs": (30, 0, 1, 0),
    "units_gs": (29, 0, 0, 0),
    "coop_oneshot_kb1_nc_cs": (11, 1, 1, 1),
    "coop_oneshot_kb1_ldg_cs": (11, 0, 1, 1),
    "coop_oneshot_kb4_ldg_cs": (11, 0, 1, 4),
    "coop_persistent_kb4_ldg_cs": (10, 0, 1, 4),
    "fixed_oneshot_kb1_cs": (20, 0, 1, 1), "fixed_oneshot_kb2_cs": (20, 0, 1, 2),
    "fixed_oneshot_kb4_cs": (20, 0, 1, 4), "fixed_oneshot_kb2_st": (20, 0, 0, 2),
    "fixed_persistent_kb2_cs": (21, 0, 1, 2),
}


def build():
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "librow_gather_variants.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(ROOT / "lab" / "row_gather_variants.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).lab
    P_, L_, I_ = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [I_, P_, L_, L_, L_, P_, L_, P_, I_, I_, I_, P_]
    fn.restype = I_
    return fn


def device_ms(fn, n=50, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("row_gather_variants: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lab = build()
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0}),
          flush=True)

    def variant(args, table, idx):
        v, nc, cs, kb = args
        out = torch.empty((idx.numel(), table.shape[1]), dtype=table.dtype,
                          device="cuda")
        size = table.element_size()
        err = lab(v, table.data_ptr(), table.shape[0], table.shape[1] * size,
                  table.stride(0) * size, idx.data_ptr(), idx.numel(),
                  out.data_ptr(), nc, cs, kb,
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {args}: CUDA error {err}")
        return out

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case, (R, C, dtype, P, window) in CASES.items():
        table = torch.randn((R, C), generator=g, device="cuda").to(dtype)
        if window is None:
            idx = torch.randint(0, R, (P,), generator=g, device="cuda")
        elif window == -1:
            idx = (100000 + torch.arange(P, device="cuda") // 16
                   + torch.randint(0, 64, (P,), generator=g, device="cuda"))
        else:
            idx = 100000 + torch.randint(0, window, (P,), generator=g,
                                         device="cuda")
        ref = table.index_select(0, idx)
        row = {"case": case, "device": smi,
               "index_select": device_ms(lambda: table.index_select(0, idx)),
               "package": device_ms(
                   lambda: gather_cuda.row_gather_kernel(table, idx))}
        for name, args in (WIDE if C >= 128 else NARROW).items():
            exact = torch.equal(variant(args, table, idx), ref)
            if not exact:
                raise SystemExit(f"row_gather_variants: {case} {name} differs "
                                 "from index_select")
            row[name] = device_ms(lambda: variant(args, table, idx))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del table, idx, ref
        torch.cuda.empty_cache()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
