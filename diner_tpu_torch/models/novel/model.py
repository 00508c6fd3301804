"""NOVEL / NOVEL_PE — the expression-deformation PixelNeRF variants.

Port of ``diner_tpu/models/novel/model.py`` (reference
``src/models/novel/novel_pixelnerf.py`` and
``src/models/novel_pe/pe_novel_pixelnerf.py``): PixelNeRF plus a learnable
latent plane ``gen_latent`` (H, W, C), channels-last as the flax parameter,
sampled where the canonical "general" camera sees the canonical points and
added to the CNN latent. NOVEL_PE also indexes precomputed per-view
positional-encoding maps of the source and target expressions and maps the
(latent + 6)-channel result back to latent width with ``deformation_layer``.
The field takes observation-space points (for the source views) and
canonical points (for the plane).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from diner_tpu_torch.geometry.transforms import (
    project_points,
    rotate_to_cam,
    uv_to_ndc,
    world_to_cam,
)
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.models.scene import SceneContext, index_latent
from diner_tpu_torch.nn.resnet import lecun_normal_
from diner_tpu_torch.nn.resnetfc import Dense, cat_aligned
from diner_tpu_torch.ops.grid_sample import (grid_sample_bilinear,
                                             grid_sample_nearest)


@dataclass
class GenContext:
    """The canonical "general" camera (``encode_gen``,
    ``novel_pixelnerf.py:76-83``) and, for NOVEL_PE, the PE maps.

    poses (SB, 1, 4, 4) world→cam; focal / c (SB, 1, 2); image_wh (2,);
    src_pe_maps (SB, NV, H, W, 3) and tgt_pe_map (SB, 1, H, W, 3) or None.
    """

    poses: torch.Tensor
    focal: torch.Tensor
    c: torch.Tensor
    image_wh: torch.Tensor
    src_pe_maps: Optional[torch.Tensor] = None
    tgt_pe_map: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class NovelPixelNeRFConfig(PixelNeRFConfig):
    gen_latent_hw: int = 192
    gen_latent_ch: int = 512
    use_pe_maps: bool = False  # NOVEL_PE


class LecunDense(Dense):
    """flax ``nn.Dense`` with its default init (lecun normal, zero bias)."""

    def reset_parameters(self, generator):
        with torch.no_grad():
            lecun_normal_(self.weight, generator)
            self.bias.zero_()


class NovelPixelNeRF(PixelNeRF):
    """PixelNeRF with the gen-latent plane (and, with ``use_pe_maps``, the
    deformation layer). ``encode`` is PixelNeRF's."""

    def __init__(self, cfg: NovelPixelNeRFConfig = NovelPixelNeRFConfig()):
        super().__init__(cfg)
        self.gen_latent = nn.Parameter(torch.empty(
            cfg.gen_latent_hw, cfg.gen_latent_hw, cfg.gen_latent_ch))
        if cfg.use_pe_maps:
            self.deformation_layer = LecunDense(
                cfg.d_latent + 6, cfg.d_latent, dtype=self.dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Every parameter from ``generator``; the plane N(0, 1)."""
        super().reset_parameters(generator)
        with torch.no_grad():
            self.gen_latent.normal_(0.0, 1.0, generator=generator)

    def index_gen_latent(self, uv_ndc):
        """The plane at normalized uv (SB, P, 2) → (SB, 1, P, C), with the
        feature-padding rescale of the CNN latent
        (``novel_pixelnerf.py:108-141``).

        The JAX package samples the plane broadcast to every source view at
        the same uv; one lookup per point gives the same values, and
        autograd of the broadcast sums the views' gradients as there.
        Plain autodiff, as in JAX: the gradient reaches the plane through
        the row gathers' ``index_add_``.
        """
        SB, P, _ = uv_ndc.shape
        Hl = Wl = self.cfg.gen_latent_hw
        fp = self.cfg.encoder.feature_padding
        scale = torch.tensor([(Wl - 2.0 * fp) / Wl, (Hl - 2.0 * fp) / Hl],
                             dtype=uv_ndc.dtype, device=uv_ndc.device)
        uv = (uv_ndc * scale).reshape(1, SB * P, 2)
        out = grid_sample_bilinear(self.gen_latent[None], uv, "border")
        return out.reshape(SB, 1, P, -1)

    def field(self, ctx: SceneContext, gen: GenContext, xyz, gen_xyz,
              viewdirs):
        """Radiance at observation-space points ``xyz`` (SB, B, 3) with the
        plane read at canonical points ``gen_xyz`` → (SB, B, 4) f32
        [sigmoid(rgb), relu(sigma)] (``novel_pixelnerf.py:143-245``)."""
        cfg = self.cfg
        SB, B, _ = xyz.shape
        NV = ctx.num_views
        xyz_cam = world_to_cam(xyz, ctx.poses)
        dirs_cam = rotate_to_cam(viewdirs, ctx.poses)
        uv = uv_to_ndc(project_points(xyz_cam, ctx.focal, ctx.c),
                       ctx.image_wh)
        latent = index_latent(ctx, uv)                  # (SB, NV, B, C)

        gen_cam = world_to_cam(gen_xyz, gen.poses)      # (SB, 1, B, 3)
        gen_uv = uv_to_ndc(project_points(gen_cam, gen.focal, gen.c),
                           gen.image_wh)
        gen_latent = self.index_gen_latent(gen_uv[:, 0])  # (SB, 1, B, C)

        if cfg.use_pe_maps:
            # the PE maps as a latent: the feature-padding rescale over
            # their own (image) size, as the JAX package does; no pair
            # table (it would be the CNN latent's)
            def pe_at(maps):
                return index_latent(dataclasses.replace(
                    ctx, latent=maps, latent_pairs=None), uv)
            tgt = gen.tgt_pe_map.expand(
                (SB, NV) + tuple(gen.tgt_pe_map.shape[2:]))
            conditioned = cat_aligned([latent, pe_at(gen.src_pe_maps),
                                       pe_at(tgt)])
            latent = self.deformation_layer(conditioned)

        final_latent = gen_latent + latent  # f32 plane: promotes, as JAX

        ref_depth = grid_sample_nearest(
            ctx.depths.reshape((SB * NV,) + tuple(ctx.depths.shape[2:])),
            uv.reshape(SB * NV, B, 2), "border").reshape(SB, NV, B)
        depth_dist = ref_depth - xyz_cam[..., 2]

        dt = self.dtype
        features = cat_aligned([cfg.poscode(xyz_cam).to(dt), dirs_cam.to(dt),
                                cfg.depthcode(depth_dist[..., None]).to(dt)])
        out = self.mlp(final_latent.to(dt), features).float()
        return torch.cat([torch.sigmoid(out[..., :3]),
                          torch.relu(out[..., 3:4])], dim=-1)

    def forward(self, images, depths, depths_std, extrinsics, intrinsics,
                gen: GenContext, xyz, gen_xyz, viewdirs):
        ctx = self.encode(images, depths, depths_std, extrinsics, intrinsics)
        return self.field(ctx, gen, xyz, gen_xyz, viewdirs)


def make_gen_context(gen_extrinsics, gen_intrinsics, image_wh,
                     src_pe_maps=None, tgt_pe_map=None) -> GenContext:
    """Pack the canonical camera: extrinsics (SB, 4, 4), intrinsics
    (SB, 3, 3), image_wh (W, H) (``encode_gen``)."""
    intr = gen_intrinsics.float()
    return GenContext(
        poses=gen_extrinsics[:, None],
        focal=torch.stack([intr[:, 0, 0], intr[:, 1, 1]], dim=-1)[:, None],
        c=intr[:, :2, 2][:, None],
        image_wh=torch.tensor([float(v) for v in image_wh],
                              dtype=torch.float32, device=intr.device),
        src_pe_maps=src_pe_maps, tgt_pe_map=tgt_pe_map)
