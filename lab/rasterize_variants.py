#!/usr/bin/env python3
"""Kernel R's designs, timed in turns on one NVIDIA GPU.

Builds ``lab/rasterize_variants.cu`` (the first design: every 16×16 tile
reads every face's box) and copies of the package's
``csrc/rasterize_depth.cu`` with some of its constants changed
(``VARIANTS``): one work item a tile (``tile_block``: a block reads its
tile's whole list, no slices to combine), 8×8 and 32×32 tiles, slices of
64 and 256 list ids, and the tile kernel's registers left to the compiler
(``occupancy5``: 5 blocks an SM), each with ``nvcc`` into ``build/lab/``
(git-ignored); the package's own build comes through
``ops/rasterize_cuda.py``. Four meshes at the multiface frame's 2048×1334
from the first ring camera: ``chip_smoke.head_mesh`` (50,400 faces) and
the same head at ``DENSE_LAT`` × ``DENSE_LON`` rings (1,008,000 faces),
whose poles pack a fan of slivers into one tile, and
``chip_smoke.cube_head_mesh`` at ``CUBE_HEAD`` and ``CUBE_DENSE`` (the
same face counts, no pole). Checks every design against
``rasterize_depth_plain`` bit for bit, then times them, device time (a
CUDA graph of ``n`` calls replayed 5 times between CUDA events, the
median), in turns: PR 11's design, the package, the package, PR 11's;
then the package, ``tile_block``, ``tile_block``, the package; then the
other variants once; then each kernel of one call of the package and of
``tile_block`` (bin, scan, scatter, tiles, and the counters' memset) from
``torch.profiler`` over 20 calls, with what the bins held.

Prints one JSON line per mesh and writes them to
``outputs/lab/rasterize_variants.json`` (git-ignored). Not part of the
package and not run by the tests: ``chip_smoke.py`` is the check of the
kernel.

Run from the repository root, on a machine with a GPU and the CUDA
toolkit:  python3 lab/rasterize_variants.py
"""

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (CUBE_DENSE, CUBE_HEAD, DENSE_LAT,  # noqa: E402
                        DENSE_LON, MF_CAMS, RASTER_HW, cube_head_mesh,
                        device_time_ms, head_mesh, ring_cameras)
from diner_tpu_torch.ops import cuda_build  # noqa: E402
from diner_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402

BUILD = ROOT / "build" / "lab"
OUT = ROOT / "outputs" / "lab" / "rasterize_variants.json"
# name → the package's constants (csrc/rasterize_depth.cu) it changes
VARIANTS = {"tile_block": {"kSlice": 1 << 24},
            "tile8": {"kTile": 8, "kChunk": 64, "kSlice": 64},
            "tile32": {"kTile": 32},
            "slice64": {"kChunk": 64, "kSlice": 64},
            "slice256": {"kSlice": 256},
            "occupancy5": {}}
LAUNCH_BOUNDS = ("__launch_bounds__(kThreads, kMinBlocks)",
                 "__launch_bounds__(kThreads)")  # occupancy5's change
P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def patched(src, name):
    """The package source with variant ``name``'s constants."""
    for const, value in VARIANTS[name].items():
        src, n = re.subn(rf"constexpr int {const} = [^;]+;",
                         f"constexpr int {const} = {value};", src)
        if n != 1:
            raise SystemExit(f"rasterize_variants: {const} not found once")
    if name == "occupancy5":
        if src.count(LAUNCH_BOUNDS[0]) != 1:
            raise SystemExit("rasterize_variants: launch bounds not found")
        src = src.replace(*LAUNCH_BOUNDS)
    return src


def scratch_ints(name, F, H, W):
    """``rc.bin_layout``'s int32 count at variant ``name``'s tile and
    slice."""
    tile = VARIANTS[name].get("kTile", rc.TILE)
    ids = VARIANTS[name].get("kSlice", rc.SLICE)
    tiles = -(-H // tile) * -(-W // tile)
    cap = rc.SPAN ** 2 * F
    items = tiles + -(-cap // ids)
    return 2 * items + 4 * tiles + 3 + F + cap


def build():
    """One nvcc a library, all started together → ({name: C function},
    {name: ptxas lines})."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = "/usr/local/cuda/bin/nvcc"
    package = (cuda_build.PKG_DIR
               / cuda_build.SOURCES["rasterize_depth"]).read_text()
    srcs = {"dense": ROOT / "lab" / "rasterize_variants.cu"}
    for name in VARIANTS:
        srcs[name] = BUILD / f"rasterize_{name}.cu"
        srcs[name].write_text(patched(package, name))
    procs = {name: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o",
         str(BUILD / f"librasterize_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in srcs.items()}
    fns, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"rasterize_variants: nvcc {name}:\n{log}")
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(BUILD / f"librasterize_{name}.so"))
        fn = lib.lab_dense if name == "dense" else lib.rasterize_depth
        fn.argtypes = ([P, P, P, I, F32, I, I, P, P, P, P] if name == "dense"
                       else rc._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs


def dense_runner(fn, uv, z, faces, H, W):
    F = faces.shape[0]

    def run():
        rec = torch.empty((F, 12), device="cuda")
        box = torch.empty((F, 4), device="cuda")
        out = torch.empty((H, W), device="cuda")
        err = cuda_build.launch(fn, uv.device, uv.data_ptr(), z.data_ptr(),
                                faces.data_ptr(), F, 1e-4, H, W,
                                rec.data_ptr(), box.data_ptr(),
                                out.data_ptr())
        if err:
            raise RuntimeError(f"dense design: CUDA error {err}")
        return out
    return run


def variant_runner(fn, name, uv, z, faces, H, W):
    F = faces.shape[0]
    ints = scratch_ints(name, F, H, W)
    sms = torch.cuda.get_device_properties(uv.device).multi_processor_count

    def run():
        rec = torch.empty((F, 12), device="cuda")
        box = torch.empty((F, 4), device="cuda")
        bins = torch.empty(ints, dtype=torch.int32, device="cuda")
        out = torch.empty((H, W), device="cuda")
        err = cuda_build.launch(fn, uv.device, uv.data_ptr(), z.data_ptr(),
                                faces.data_ptr(), F, 1e-4, H, W,
                                rec.data_ptr(), box.data_ptr(),
                                bins.data_ptr(), out.data_ptr(), sms)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out
    return run


def kernel_times(fn, calls=20):
    """Device µs a call of each kernel (and memset) ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    out = {}
    for e in events:
        for name in ("rasterize_bin", "rasterize_scan", "rasterize_scatter",
                     "rasterize_tiles", "Memset"):
            if name in e.key:
                out[name] = {"us": getattr(e, attr) / calls,
                             "launches": e.count / calls}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("rasterize_variants: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    fns, ptxas = build()
    rc._launcher()  # the package's build
    print(json.dumps({"device": smi, "build_s": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    K, E = next(iter(ring_cameras(MF_CAMS).values()))
    H, W = RASTER_HW
    meshes = {"multiface_head": lambda: head_mesh(0),
              "dense_head": lambda: head_mesh(0, n_lat=DENSE_LAT,
                                              n_lon=DENSE_LON),
              "cube_head": lambda: cube_head_mesh(*CUBE_HEAD),
              "cube_dense": lambda: cube_head_mesh(*CUBE_DENSE)}
    rows, bad = [], []
    for case, make in meshes.items():
        verts, faces_np = make()
        uv, z = rc.project(torch.from_numpy(verts).cuda(),
                           torch.from_numpy(K).cuda(),
                           torch.from_numpy(E).cuda())
        faces = torch.from_numpy(faces_np).cuda()
        ref = rc.rasterize_depth_plain(uv, z, faces, H, W, pixel_block=16384,
                                       face_chunk=8192)
        _, bins = rc.rasterize_depth_kernel_bins(uv, z, faces, H, W)
        counts = bins["counts"][bins["counts"] > 0].float()
        fn = {"dense": dense_runner(fns["dense"], uv, z, faces, H, W),
              "package": lambda: rc.rasterize_depth_kernel(  # noqa: B023
                  uv, z, faces, H, W)}  # noqa: B023
        for name in VARIANTS:
            fn[name] = variant_runner(fns[name], name, uv, z, faces, H, W)
        row = {"case": case, "device": smi, "H": H, "W": W,
               "V": uv.shape[0], "F": faces.shape[0],
               "bin_entries": bins["entries"], "large_faces": bins["large"],
               "occupied_tiles": counts.numel(),
               "tiles": bins["counts"].numel(),
               "mean_list": float(counts.mean()),
               "max_list": int(counts.max()),
               "work_items": int(torch.clamp(torch.ceil(counts / rc.SLICE),
                                             min=1).sum()),
               "exact": {}}
        for name, f in fn.items():
            got = f()
            torch.cuda.synchronize()
            row["exact"][name] = torch.equal(got, ref)
            if not row["exact"][name]:
                bad.append((case, name))
        n = 10 if "dense" in case else 20
        turns = []
        for name in ("dense", "package", "package", "dense",
                     "package", "tile_block", "tile_block", "package",
                     *(v for v in VARIANTS if v != "tile_block")):
            turns.append([name, device_time_ms(fn[name], n=n)])
        row["turns_ms"] = turns
        row["kernels_us"] = {name: kernel_times(fn[name])
                             for name in ("package", "tile_block")}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del uv, z, faces, ref
        torch.cuda.empty_cache()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(rows, indent=1))
    if bad:
        raise SystemExit(f"rasterize_variants: maps differ: {bad}")


if __name__ == "__main__":
    main()
