"""Camera-space transforms and perspective projection.

Port of ``diner_tpu/geometry/transforms.py``; same shapes and conventions
(world→cam extrinsics, OpenCV pinhole, align_corners=False uv).
"""

from __future__ import annotations

import torch


def world_to_cam(xyz, poses):
    """(SB, B, 3) world points → (SB, NV, B, 3) camera-space points.

    poses: (SB, NV, 4, 4) world→camera extrinsics.
    """
    rot = poses[:, :, :3, :3]
    trans = poses[:, :, :3, 3]
    return (torch.matmul(xyz[:, None], rot.transpose(-1, -2))
            + trans[:, :, None, :])


def rotate_to_cam(dirs, poses):
    """(SB, B, 3) world directions → (SB, NV, B, 3), rotation only."""
    return torch.matmul(dirs[:, None], poses[:, :, :3, :3].transpose(-1, -2))


def project_points(xyz_cam, focal, c):
    """(SB, NV, B, 3) camera points → (SB, NV, B, 2) pixel coordinates.

    focal, c: (SB, NV, 2) [fx, fy] and principal point [cx, cy].
    """
    uv = xyz_cam[..., :2] / xyz_cam[..., 2:3]
    return uv * focal[:, :, None, :] + c[:, :, None, :]


def uv_to_ndc(uv_pix, image_wh):
    """Pixel coords → [-1, 1] with ±1 at the outer pixel edges.

    image_wh: (2,) [W, H] tensor or sequence.
    """
    wh = torch.as_tensor(image_wh, dtype=uv_pix.dtype, device=uv_pix.device)
    return uv_pix / wh * 2.0 - 1.0
