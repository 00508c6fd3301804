"""SceneContext — the encoded source views the field and sampler read.

Port of ``diner_tpu/models/scene.py`` as a plain dataclass of tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from diner_tpu_torch.ops.grid_sample import (
    build_pair_table,
    grid_sample_bilinear_imggrad,
    grid_sample_bilinear_pairs,
)
from diner_tpu_torch.ops.sampling import ViewMaps


@dataclass
class SceneContext:
    """Shapes:
      latent (SB, NV, H_lat, W_lat, C); depths / depth_stds (SB, NV, H, W, 1);
      normals (SB, NV, H, W, 3); poses (SB, NV, 4, 4) world→cam;
      focal / c (SB, NV, 2); image_wh (2,) [W, H];
      feature_padding: latent-canvas padding in latent pixels;
      latent_pairs: None, or the latent's pair table (with_latent_pairs).
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
    latent_pairs: Optional[torch.Tensor] = None

    @property
    def num_views(self) -> int:
        return self.poses.shape[1]

    def with_latent_pairs(self) -> "SceneContext":
        """Attach the wide-row x-pair latent table (2× the latent's bytes),
        built once per encode; every later lookup fetches two rows instead
        of four. Forward only (the train step keeps the 4-corner lookup);
        an odd latent width leaves the context as it is."""
        if self.latent_pairs is not None or self.latent.shape[3] % 2:
            return self
        lat = self.latent.reshape((-1,) + tuple(self.latent.shape[2:]))
        return dataclasses.replace(self, latent_pairs=build_pair_table(lat))

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
    if ctx.latent_pairs is not None:
        # pair-table lookup: the same values, two row fetches per point
        return grid_sample_bilinear_pairs(
            ctx.latent_pairs, (SB * NV,) + tuple(ctx.latent.shape[2:]), uv,
            "border").reshape(SB, NV, P, -1)
    latent = ctx.latent.reshape((SB * NV,) + tuple(ctx.latent.shape[2:]))
    # image-only VJP with f32 accumulation, as the JAX package's lookup
    return grid_sample_bilinear_imggrad(latent, uv, "border").reshape(
        SB, NV, P, -1)
