"""The top-1 nearest-vertex lookup as a CUDA kernel, and its plain version.

``csrc/knn1.cu`` replaces the JAX package's ``diner_tpu/ops/knn.py:knn1``
(not a Pallas kernel: an MXU matmul over chunked distance tiles, standing
in for pytorch3d's ``knn_points`` with K = 1 in the reference's NOVEL
renderer); its bound and design are in the source. For each scene and
point it returns the index of the vertex with the least

    d² = (−2 · ((px·vx + py·vy) + pz·vz)) + ((vx·vx + vy·vy) + vz·vz),

|p|² dropped, every product and sum rounded on its own, ties to the lower
index and the first NaN distance before every number (``argmin``'s rules). :func:`knn1_plain` computes that expression with
elementwise tensor ops on (chunk, V) tiles, so the kernel and the plain
version choose the same vertex; ``chunk`` bounds only the plain version's
tile, the kernel takes the whole call in one launch.

:func:`knn1` runs the plain version for CPU tensors and launches the kernel
for CUDA ones, or raises. The index comes from an argmin and passes no
gradient, so there is no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import cuda_build

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _L, _I, _I, _P]
MAX_SCENES = 65535  # gridDim.y


@functools.cache
def _launcher():
    fn = cuda_build.load("knn1").knn1
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(points, vertices):
    if points.dim() != 3 or points.shape[-1] != 3 or vertices.dim() != 3 \
            or vertices.shape[-1] != 3 \
            or vertices.shape[0] != points.shape[0]:
        raise ValueError(f"knn1: points {tuple(points.shape)} and vertices "
                         f"{tuple(vertices.shape)}, expected (SB, N, 3) and "
                         "(SB, V, 3)")
    if vertices.shape[1] == 0:
        raise ValueError("knn1: no vertices")
    if points.device != vertices.device:
        raise ValueError(f"knn1: points on {points.device}, vertices on "
                         f"{vertices.device}")


def knn1_plain(points, vertices, chunk: int = 2048):
    """The plain version: (SB, N, 3) points, (SB, V, 3) vertices → (SB, N)
    int32 indices of the nearest vertex, in f32 on (chunk, V) tiles."""
    _check(points, vertices)
    p = points.float()
    v = vertices.float()
    vx, vy, vz = (v[..., k][:, None, :] for k in range(3))  # (SB, 1, V)
    v_sq = (vx * vx + vy * vy) + vz * vz
    SB, N, _ = p.shape
    out = []
    for s in range(0, N, max(int(chunk), 1)):
        c = p[:, s:s + chunk]
        d2 = c[..., 0:1] * vx
        d2 += c[..., 1:2] * vy
        d2 += c[..., 2:3] * vz
        d2 *= -2.0
        d2 += v_sq
        out.append(d2.argmin(-1))
    if not out:
        return torch.zeros((SB, 0), dtype=torch.int32, device=p.device)
    return torch.cat(out, dim=1).to(torch.int32)


def knn1_kernel(points, vertices):
    """Launch the kernel: (SB, N, 3), (SB, V, 3) f32 CUDA tensors (made
    contiguous) → (SB, N) int32."""
    global launches
    _check(points, vertices)
    if points.device.type != "cuda":
        raise ValueError(f"knn1 kernel: points on {points.device}, expected "
                         "a CUDA device")
    if points.dtype != torch.float32 or vertices.dtype != torch.float32:
        raise ValueError(f"knn1 kernel: {points.dtype} points and "
                         f"{vertices.dtype} vertices, expected float32")
    SB, N, _ = points.shape
    if SB > MAX_SCENES:
        raise ValueError(f"knn1 kernel: {SB} scenes, at most {MAX_SCENES}")
    points = points.contiguous()
    vertices = vertices.contiguous()
    out = torch.empty((SB, N), dtype=torch.int32, device=points.device)
    if N == 0:
        return out
    err = cuda_build.launch(_launcher(), points.device, points.data_ptr(),
                            vertices.data_ptr(), out.data_ptr(), N,
                            vertices.shape[1], SB)
    if err != 0:
        raise RuntimeError(f"knn1 kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def knn1(points, vertices, chunk: int = 2048):
    """Index of the nearest vertex of every point: (SB, N, 3), (SB, V, 3)
    → (SB, N) int32. The kernel for CUDA tensors, the plain version (tiles
    of ``chunk`` points) for CPU ones."""
    if points.device.type == "cpu":
        return knn1_plain(points, vertices, chunk)
    return knn1_kernel(points, vertices)
