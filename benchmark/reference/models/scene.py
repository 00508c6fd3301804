"""SceneContext — the encoded source views the field and sampler read.

Port of ``diner_tpu/models/scene.py`` as a plain dataclass of tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference.ops.grid_sample import grid_sample_bilinear_imggrad
from benchmark.reference.ops.sampling import ViewMaps


@dataclass
class SceneContext:
    """Shapes:
      latent (SB, NV, H_lat, W_lat, C); depths / depth_stds (SB, NV, H, W, 1);
      normals (SB, NV, H, W, 3); poses (SB, NV, 4, 4) world→cam;
      focal / c (SB, NV, 2); image_wh (2,) [W, H];
      feature_padding: latent-canvas padding in latent pixels.
    """

    latent: torch.Tensor
    depths: torch.Tensor
    depth_stds: torch.Tensor
    normals: torch.Tensor
    poses: torch.Tensor
    focal: torch.Tensor
    c: torch.Tensor
    image_wh: torch.Tensor
    feature_padding: int = 0

    @property
    def num_views(self) -> int:
        return self.poses.shape[1]

    def view_maps(self) -> ViewMaps:
        return ViewMaps(depths=self.depths, depth_stds=self.depth_stds,
                        normals=self.normals, poses=self.poses,
                        focal=self.focal, c=self.c, image_wh=self.image_wh)


def index_latent(ctx: SceneContext, uv_ndc):
    """Pixel-aligned bilinear/border latent lookup.

    The latent canvas covers the padded image, so coordinates on the
    unpadded image shrink by (size − 2·pad) / size first.
    uv_ndc: (SB, NV, P, 2) → (SB, NV, P, C).
    """
    SB, NV, P, _ = uv_ndc.shape
    Hl, Wl = ctx.latent.shape[2], ctx.latent.shape[3]
    pad = ctx.feature_padding
    scale = torch.tensor([(Wl - 2.0 * pad) / Wl, (Hl - 2.0 * pad) / Hl],
                         dtype=uv_ndc.dtype, device=uv_ndc.device)
    uv = (uv_ndc * scale).reshape(SB * NV, P, 2)
    latent = ctx.latent.reshape((SB * NV,) + tuple(ctx.latent.shape[2:]))
    # image-only VJP with f32 accumulation, as the JAX package's lookup
    return grid_sample_bilinear_imggrad(latent, uv).reshape(
        SB, NV, P, -1)
