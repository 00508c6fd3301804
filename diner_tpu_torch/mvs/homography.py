"""Plane-sweep homography warping.

Port of ``diner_tpu/mvs/homography.py`` (reference ``deps/TransMVSNet/
models/module.py:284-322``): each reference pixel at each hypothesis depth
is projected into the source view and the source features are sampled
there bilinearly (zeros outside, ``align_corners=True``), pixels behind the
camera (z < 1e-6) pushed off the grid to −99. The projection math runs in
f32 whatever the feature dtype: bf16 cannot hold integer pixel coordinates
above 256. The sampling is ``ops/grid_sample.py``'s
``grid_sample_bilinear_imggrad``, whose 4 corner fetches are flat row
gathers (kernel C on the card); the grid takes no gradient.
"""

from __future__ import annotations

import torch

from diner_tpu_torch.ops.grid_sample import grid_sample_bilinear_imggrad


def homo_warping(src_fea, src_proj, ref_proj, depth_values):
    """Warp source features to the reference view's depth hypotheses.

    Args:
      src_fea: (B, H, W, C) source features, contiguous (channels-last).
      src_proj / ref_proj: (B, 4, 4) full projection matrices (K·[R|t]).
      depth_values: (B, D) or (B, D, H, W) hypothesis depths.

    Returns:
      (B, D, H, W, C) warped features.
    """
    B, H, W, C = src_fea.shape
    D = depth_values.shape[1]
    dev = src_fea.device
    proj = src_proj.float() @ torch.linalg.inv(ref_proj.float())
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    xyz = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(H * W, dtype=torch.float32, device=dev)])
    rot_xyz = torch.einsum("bij,jp->bip", rot, xyz)  # (B, 3, HW)
    dv = depth_values.float().reshape(B, 1, D, -1)
    proj_xyz = rot_xyz[:, :, None, :] * dv + trans[:, :, None, None]
    z = proj_xyz[:, 2]  # (B, D, HW)
    invalid = z < 1e-6
    xy = proj_xyz[:, :2] / torch.where(invalid, torch.ones_like(z), z)[:, None]
    x_n = xy[:, 0] / ((W - 1) / 2.0) - 1.0
    y_n = xy[:, 1] / ((H - 1) / 2.0) - 1.0
    off = torch.full_like(x_n, -99.0)
    grid = torch.stack([torch.where(invalid, off, x_n),
                        torch.where(invalid, off, y_n)], dim=-1).detach()
    warped = grid_sample_bilinear_imggrad(
        src_fea, grid.reshape(B, D * H * W, 2), padding_mode="zeros",
        align_corners=True)
    return warped.reshape(B, D, H, W, C)
