"""Camera-ray generation (OpenCV convention, half-pixel centers).

Port of ``diner_tpu/geometry/rays.py``.
"""

from __future__ import annotations

import torch


def gen_rays(extrinsics, intrinsics, W: int, H: int, z_near, z_far):
    """World-space rays for every pixel.

    Args:
      extrinsics: (B, 4, 4) world→camera; intrinsics: (B, 3, 3).
      W, H: image width / height.
      z_near, z_far: (B,) near/far bounds.

    Returns:
      (B, H, W, 8): [origin(3), unit direction(3), near(1), far(1)].
    """
    B = extrinsics.shape[0]
    dtype, device = extrinsics.dtype, extrinsics.device
    intrinsics = intrinsics.to(dtype)
    focal = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1]], -1)
    c = intrinsics[:, :2, 2]

    xs = torch.arange(0.5, W, 1.0, dtype=dtype, device=device)
    ys = torch.arange(0.5, H, 1.0, dtype=dtype, device=device)
    # jnp.meshgrid defaults to "xy"; torch needs it spelled out
    grid_x, grid_y = torch.meshgrid(xs, ys, indexing="xy")  # (H, W)
    pcoords = torch.stack([grid_x, grid_y], dim=-1)

    pcoords_cam = (pcoords[None] - c[:, None, None]) / focal[:, None, None]
    pcoords_cam = torch.cat(
        [pcoords_cam, torch.ones_like(pcoords_cam[..., :1])], dim=-1)
    raydirs_cam = pcoords_cam / torch.linalg.norm(
        pcoords_cam, dim=-1, keepdim=True)

    rot_c2w = extrinsics[:, :3, :3].transpose(-1, -2)  # (B, 3, 3)
    raydirs_world = torch.matmul(raydirs_cam, rot_c2w[:, None].transpose(-1, -2))
    cam_centers = -torch.matmul(rot_c2w, extrinsics[:, :3, 3:4])[..., 0]
    origins = cam_centers[:, None, None, :].expand(B, H, W, 3)

    near = torch.as_tensor(z_near, dtype=dtype, device=device).reshape(
        B, 1, 1, 1).expand(B, H, W, 1)
    far = torch.as_tensor(z_far, dtype=dtype, device=device).reshape(
        B, 1, 1, 1).expand(B, H, W, 1)
    return torch.cat([origins, raydirs_world, near, far], dim=-1)
