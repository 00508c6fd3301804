"""Depth map → camera-space normal map by central differences.

Port of ``diner_tpu/geometry/normals.py``, including the boundary cleanup
that borrows the normal of the pixel shifted away from an invalid neighbour.
"""

from __future__ import annotations

import torch


def depth_to_normal(dmap, intrinsics):
    """(N, H, W) depth (0 = invalid) + (N, 3, 3) intrinsics → (N, H, W, 3)
    unit normals, zero where depth == 0."""
    N, H, W = dmap.shape
    dtype, device = dmap.dtype, dmap.device
    intrinsics = intrinsics.to(dtype)
    focal = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1]], -1)
    c = intrinsics[:, :2, 2]

    xs = torch.arange(0.5, W, 1.0, dtype=dtype, device=device)
    ys = torch.arange(0.5, H, 1.0, dtype=dtype, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    rays = torch.stack([gx, gy], dim=-1)
    rays = (rays[None] - c[:, None, None]) / focal[:, None, None]
    rays = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    pts = rays * dmap[..., None]  # (N, H, W, 3)

    # edge-padded neighbours: clamped row/column indices
    rows = torch.arange(H, device=device)
    cols = torch.arange(W, device=device)
    down = pts[:, (rows + 1).clamp(max=H - 1)]
    up = pts[:, (rows - 1).clamp(min=0)]
    right = pts[:, :, (cols + 1).clamp(max=W - 1)]
    left = pts[:, :, (cols - 1).clamp(min=0)]

    normal = torch.linalg.cross(down - up, right - left, dim=-1)
    norm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.where(norm == 0, torch.ones_like(norm), norm)

    # where a neighbour is invalid (x == 0), take the normal of the pixel
    # shifted away from it; opposite offsets cancel
    dy = (up[..., 0] == 0).long() - (down[..., 0] == 0).long()
    dx = (left[..., 0] == 0).long() - (right[..., 0] == 0).long()
    offset_mask = (dy != 0) | (dx != 0)
    new_row = (rows[None, :, None] + dy).clamp(0, H - 1)
    new_col = (cols[None, None, :] + dx).clamp(0, W - 1)
    flat = normal.reshape(N, H * W, 3)
    idx = (new_row * W + new_col).reshape(N, H * W, 1).expand(N, H * W, 3)
    gathered = torch.gather(flat, 1, idx).reshape(N, H, W, 3)
    normal = torch.where(offset_mask[..., None], gathered, normal)
    return torch.where((dmap == 0)[..., None], torch.zeros_like(normal),
                       normal)
