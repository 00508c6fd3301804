"""Mesh depth rasterization (the ground-truth depth of the preprocessing).

Port of ``diner_tpu/preprocessing/rasterize.py``. The reference renders
ground-truth depth with pyrender/EGL (``deps/facescape_preprocessing/
renderer.py:11-64``, ``deps/multiface/process_dataset.py``); here the
z-buffer is kernel R (``ops/rasterize_cuda.py``, ``csrc/rasterize_depth.cu``)
on the card and its plain version on the CPU. One difference from the JAX
function: a face with ``|denom| < 1e-12`` (zero screen area) is dropped
instead of covering the whole map.
"""

from __future__ import annotations

import numpy as np
import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.ops.rasterize_cuda import project, rasterize


def rasterize_depth(vertices, faces, K, Rt, H: int, W: int,
                    znear: float = 1e-4, pixel_block: int = 4096,
                    face_chunk: int = 4096, device=None):
    """Render a z-buffer depth map of a triangle mesh.

    Args:
      vertices: (V, 3) world-space vertices.
      faces: (F, 3) int vertex indices.
      K: (3, 3) intrinsics; Rt: (3, 4) or (4, 4) world→cam extrinsics.
      H, W: output resolution.
      pixel_block, face_chunk: the plain version's tile (CPU only).
      device: where numpy inputs go (default ``cuda``); a tensor input
        keeps its own device.

    Returns:
      (H, W) float32 z-depth tensor on the inputs' device; 0 where no
      triangle covers the pixel.
    """
    if isinstance(vertices, torch.Tensor):
        v = vertices
    else:
        v = torch.as_tensor(np.asarray(vertices, np.float32),
                            device=resolve_device(device))
    dev = v.device
    f = torch.as_tensor(faces, device=dev)
    if f.numel() and (int(f.min()) < 0 or int(f.max()) >= v.shape[0]):
        raise ValueError(f"rasterize_depth: face indices outside "
                         f"[0, {v.shape[0]})")
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    Rt = torch.as_tensor(Rt, dtype=torch.float32, device=dev)
    uv, z = project(v, K, Rt)
    return rasterize(uv, z, f.reshape(-1, 3), int(H), int(W), znear,
                     pixel_block, face_chunk)


def load_obj_vertices_faces(path):
    """Minimal OBJ parser (v / f lines only) → (verts (V,3), faces (F,3))."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32))
