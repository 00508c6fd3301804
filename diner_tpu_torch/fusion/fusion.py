"""ctypes bindings and helpers of the C++/OpenMP fusion library (the MVS
"gipuma" fusion backend).

Port-side copy of ``diner_tpu/fusion/fusion.py``. ``src/fusion.cpp`` (a
copy of the JAX package's) reproduces the consistency test of the
reference's CUDA ``fusibile`` kernel on the host; this module adds the
protocol of ``deps/TransMVSNet/gipuma.py``: the ``.dmb``
codec, probability filtering, the constant normals and PLY output. The
shared library is built with ``g++ -O3 -fopenmp`` at first use into
``build/fusion/`` at the repository root (git-ignored), its name carrying
a hash of the source and flags; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "fusion.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fusion"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libdiner_fusion-{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile the shared library unless this source is built already."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load():
    lib = ctypes.CDLL(str(build_library()))
    lib.fuse_depth_maps.restype = ctypes.c_longlong
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.fuse_depth_maps.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, ctypes.c_void_p, f32p, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        f32p, ctypes.c_longlong,
    ]
    return lib


def fuse_depth_maps(depths, normals, P, focals, colors=None,
                    disp_thresh: float = 0.25, normal_thresh: float = 0.52,
                    num_consistent: int = 3,
                    capacity: Optional[int] = None) -> np.ndarray:
    """Fuse per-view depth maps into a consistent point cloud.

    Args:
      depths: (V, H, W) float32 (0 = invalid).
      normals: (V, H, W, 3) float32 unit normals.
      P: (V, 3, 4) projection matrices K[R|t].
      focals: (V,) focal lengths (pixels).
      colors: optional (V, H, W, 3) float32 in [0, 1].
      disp_thresh / normal_thresh / num_consistent: fusibile parameters
        (defaults per gipuma.py / algorithmparameters.h).

    Returns:
      (N, 10) float32 [x y z nx ny nz r g b n_consistent].
    """
    lib = _load()
    depths = np.ascontiguousarray(depths, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    V, H, W = depths.shape
    P = np.ascontiguousarray(np.asarray(P, np.float32).reshape(V, 12))
    focals = np.ascontiguousarray(focals, np.float32)
    if capacity is None:
        capacity = int(V * H * W)
    out = np.empty((capacity, 10), np.float32)

    colors_ptr = None
    if colors is not None:
        colors = np.ascontiguousarray(colors, np.float32)
        colors_ptr = colors.ctypes.data_as(ctypes.c_void_p)

    n = lib.fuse_depth_maps(V, H, W, depths, normals, colors_ptr, P, focals,
                            float(disp_thresh), float(normal_thresh),
                            int(num_consistent), out, capacity)
    if n < 0:
        raise RuntimeError("singular camera matrix in fusion")
    return out[:n]


# ------------------------------------------------------- gipuma protocol

def read_gipuma_dmb(path) -> np.ndarray:
    """Gipuma .dmb image (gipuma.py:20-31)."""
    with open(path, "rb") as f:
        _type, height, width, channels = struct.unpack("<iiii", f.read(16))
        arr = np.fromfile(f, np.float32)
    arr = arr.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_gipuma_dmb(path, image: np.ndarray):
    """Gipuma .dmb writer (gipuma.py:34-55)."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    ch = image.shape[2] if image.ndim == 3 else 1
    arr = np.transpose(image, (2, 0, 1)) if image.ndim == 3 else image
    with open(path, "wb") as f:
        f.write(struct.pack("<iiii", 1, h, w, ch))
        arr.astype(np.float32).tofile(f)


def probability_filter(depth: np.ndarray, prob: np.ndarray,
                       prob_threshold: float) -> np.ndarray:
    """Zero out depths below the confidence threshold (gipuma.py:153-167)."""
    out = depth.copy()
    out[prob < prob_threshold] = 0.0
    return out


def fake_normals(depth: np.ndarray) -> np.ndarray:
    """gipuma.py's constant (1,1,1)/√3 normals masked by validity
    (gipuma.py:91-108); makes the normal test trivially pass."""
    n = np.full(depth.shape + (3,), 1.0 / 1.732050808, np.float32)
    return n * (depth > 0)[..., None]


def write_ply(path, points: np.ndarray, with_normals: bool = True,
              with_colors: bool = True):
    """Write fused points (N, >=10) as binary little-endian PLY."""
    n = len(points)
    props = ["x", "y", "z"]
    cols = [0, 1, 2]
    if with_normals:
        props += ["nx", "ny", "nz"]
        cols += [3, 4, 5]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {p}" for p in props]
    if with_colors:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]

    data = points[:, cols].astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if with_colors:
            rgb = np.clip(points[:, 6:9] * 255, 0, 255).astype(np.uint8)
            # interleave float properties and uchar colors row by row
            rec = np.dtype([("f", "<f4", (len(cols),)), ("c", "u1", (3,))])
            buf = np.empty(n, rec)
            buf["f"] = data
            buf["c"] = rgb
            buf.tofile(f)
        else:
            data.tofile(f)


def read_ply(path):
    """A PLY that :func:`write_ply` wrote → (property names, (N, k) float32
    of its float properties, (N, 3) uint8 colours or None); raises on any
    other layout."""
    with open(path, "rb") as f:
        header = []
        while not header or header[-1] != "end_header":
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header.append(line.decode("ascii").strip())
        body = f.read()
    if header[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    n = int(header[2].split()[-1])
    floats = [h.split()[-1] for h in header if h.startswith("property float")]
    n_colors = sum(h.startswith("property uchar") for h in header)
    rec = np.dtype([("f", "<f4", (len(floats),))]
                   + ([("c", "u1", (3,))] if n_colors == 3 else []))
    if n_colors not in (0, 3) or len(body) != n * rec.itemsize:
        raise ValueError(f"{path}: {len(body)} bytes for {n} vertices of "
                         f"{rec.itemsize}")
    data = np.frombuffer(body, rec)
    return floats, data["f"].copy(), (data["c"].copy() if n_colors else None)


def fuse_dense_folder(scan_dir, stems, out, prob_threshold: float = 0.9,
                      disp_threshold: float = 0.25,
                      normal_threshold: float = 0.52,
                      num_consistent: int = 3) -> np.ndarray:
    """Fuse the views ``stems`` of a dense folder into the PLY ``out``
    (gipuma.py:192-213): each depth map probability-filtered, constant
    normals, :func:`fuse_depth_maps`. The folder holds
    ``cams/<stem>_cam.txt``, ``depth_est/<stem>.pfm``,
    ``confidence/<stem>.pfm`` and, for point colours,
    ``images/<stem>.jpg|png`` (without them for every view, the PLY has
    none). Returns the fused (N, 10) points."""
    from diner_tpu_torch.data.dtu import read_cam_file
    from diner_tpu_torch.data.io import read_pfm, read_rgb

    scan = Path(scan_dir)
    depths, Ps, focals, colors = [], [], [], []
    for stem in stems:
        depth = np.asarray(read_pfm(scan / "depth_est" / f"{stem}.pfm")[0],
                           np.float32)
        conf = np.asarray(read_pfm(scan / "confidence" / f"{stem}.pfm")[0],
                          np.float32)
        depths.append(probability_filter(depth, conf, prob_threshold))
        K, E, _ = read_cam_file(scan / "cams" / f"{stem}_cam.txt")
        Ps.append((K @ E[:3]).astype(np.float32))
        focals.append(K[0, 0])
        img = None
        for ext in (".jpg", ".png"):
            p = scan / "images" / f"{stem}{ext}"
            if p.exists():
                img = read_rgb(p)[..., :3]
                break
        colors.append(img)

    depths = np.stack(depths)
    colors = (np.stack(colors) if all(c is not None for c in colors)
              else None)
    pts = fuse_depth_maps(depths, np.stack([fake_normals(d) for d in depths]),
                          np.stack(Ps), np.asarray(focals, np.float32),
                          colors, disp_thresh=disp_threshold,
                          normal_thresh=normal_threshold,
                          num_consistent=num_consistent)
    write_ply(out, pts, with_colors=colors is not None)
    return pts
