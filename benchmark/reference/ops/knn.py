"""Top-1 nearest-vertex lookup and the mesh deformation of NOVEL.

Port of ``diner_tpu/ops/knn.py`` (the JAX package's stand-in for
pytorch3d's CUDA ``knn_points`` with K = 1, reference
``src/models/novel/nerf_novel_renderer.py:40-50``). :func:`knn1` is
the plain chunked search here, as the port's plain version
on the CPU, int32 indices, ties to the lower index. :func:`deform_points`
moves each point by the offset of its nearest vertex; the offsets are
fetched by ``index_select`` (12 B rows).
"""

from __future__ import annotations

import torch

__all__ = ["knn1", "deform_points"]


def knn1(points, vertices, chunk: int = 2048):
    """(SB, N, 3) points, (SB, V, 3) vertices → (SB, N) int32 indices of
    the nearest vertex, in f32 on (chunk, V) tiles; ties to the lower
    index."""
    p = points.float()
    v = vertices.float()
    vx, vy, vz = (v[..., k][:, None, :] for k in range(3))  # (SB, 1, V)
    v_sq = (vx * vx + vy * vy) + vz * vz
    out = []
    for s in range(0, p.shape[1], max(int(chunk), 1)):
        c = p[:, s:s + chunk]
        d2 = c[..., 0:1] * vx
        d2 += c[..., 1:2] * vy
        d2 += c[..., 2:3] * vz
        d2 *= -2.0
        d2 += v_sq
        out.append(d2.argmin(-1))
    return torch.cat(out, dim=1).to(torch.int32)


def deform_points(points, target_vertices, offsets, chunk: int = 2048):
    """``points + offsets[nearest target vertex]``: (SB, N, 3) points,
    (SB, V, 3) vertices and offsets → (SB, N, 3). The index passes no
    gradient; the points' gradient passes through unchanged."""
    idx = knn1(points, target_vertices, chunk)  # (SB, N) int32
    SB, V, _ = offsets.shape
    base = torch.arange(SB, device=idx.device)[:, None] * V
    off = offsets.reshape(SB * V, 3).to(points.dtype).index_select(
        0, (idx + base).reshape(-1))
    return points + off.reshape(points.shape)
