"""Top-1 nearest-vertex lookup and the mesh deformation of NOVEL.

Port of ``diner_tpu/ops/knn.py`` (the JAX package's stand-in for
pytorch3d's CUDA ``knn_points`` with K = 1, reference
``src/models/novel/nerf_novel_renderer.py:40-50``). :func:`knn1` is
``ops/knn_cuda.py:knn1``: the kernel on the card, the plain chunked version
on the CPU, int32 indices, ties to the lower index. :func:`deform_points`
moves each point by the offset of its nearest vertex; the offsets are
fetched by the flat row gather (kernel C on the card, 12 B rows).
"""

from __future__ import annotations

import torch

from diner_tpu_torch.ops.gather_cuda import row_gather
from diner_tpu_torch.ops.knn_cuda import knn1

__all__ = ["knn1", "deform_points"]


def deform_points(points, target_vertices, offsets, chunk: int = 2048):
    """``points + offsets[nearest target vertex]``: (SB, N, 3) points,
    (SB, V, 3) vertices and offsets → (SB, N, 3). The index passes no
    gradient; the points' gradient passes through unchanged."""
    idx = knn1(points, target_vertices, chunk)  # (SB, N) int32
    SB, V, _ = offsets.shape
    base = torch.arange(SB, device=idx.device)[:, None] * V
    off = row_gather(offsets.reshape(SB * V, 3).to(points.dtype),
                     (idx + base).reshape(-1))
    return points + off.reshape(points.shape)
