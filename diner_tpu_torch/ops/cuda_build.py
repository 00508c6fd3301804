"""Build and load the port's CUDA kernels: ``nvcc`` → shared library →
``ctypes``.

Each source under ``diner_tpu_torch/csrc/`` exposes a plain C launcher and
is compiled for ``sm_90a`` into ``build/kernels/`` at the repository root
(listed in ``.gitignore``) at first use, with ``-I`` on ``csrc/`` for the
headers the sources share (``composite_scan.cuh``, kernels A and B). The
library name carries a hash of the source, every header under ``csrc/``
and the flags, so an edited source or header is rebuilt. :func:`launch`
calls a launcher on PyTorch's current stream. Nothing here runs at import: a
machine without ``nvcc`` can import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = {"composite_fwd": "csrc/composite_fwd.cu",
           "composite_bwd": "csrc/composite_bwd.cu",
           "row_gather": "csrc/row_gather.cu",
           "dcn_sample_bwd": "csrc/dcn_sample_bwd.cu",
           "knn1": "csrc/knn1.cu",
           "rasterize_depth": "csrc/rasterize_depth.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}  # name → ctypes.CDLL, one load per process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [PKG_DIR / SOURCES[name],
                 *sorted((PKG_DIR / CSRC).glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list:
    """The ``nvcc`` command line that builds kernel ``name`` into ``out``."""
    return [nvcc, *NVCC_FLAGS, "-I", str(PKG_DIR / CSRC), "-o", str(out),
            str(PKG_DIR / SOURCES[name])]


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` process per source, all started together. Returns
    ``{name: {"seconds": s, "log": ptxas report}}`` for what was compiled.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, library_path(name))
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built if needed and loaded once."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher ``fn`` with ``args`` and the current stream of
    the CUDA ``device``, switching the current device only when it is
    another one; returns the launcher's CUDA error code."""
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        return fn(*args, raw_stream(device.index))
    with torch.cuda.device(device.index):
        return fn(*args, raw_stream(device.index))
