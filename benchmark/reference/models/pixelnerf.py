"""PixelNeRF — the conditioned radiance field.

Port of ``diner_tpu/models/pixelnerf.py``: ``encode`` builds the
:class:`SceneContext` (ImageNet normalization, depth→normal, spatial
encoder); ``field`` maps world points to [sigmoid(rgb), relu(sigma)]
through per-view camera transforms, positional encodings, the
pixel-aligned latent and depth-distance features, and the ResnetFC with
mean fusion over views. Parameter names follow the flax tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import torch
import torch.nn as nn

from benchmark.reference.geometry.normals import depth_to_normal
from benchmark.reference.geometry.transforms import (
    project_points,
    rotate_to_cam,
    uv_to_ndc,
    world_to_cam,
)
from benchmark.reference.models.scene import SceneContext, index_latent
from benchmark.reference.nn.positional_encoding import PositionalEncoding
from benchmark.reference.nn.resnetfc import ResnetFC
from benchmark.reference.nn.spatial_encoder import (
    SpatialEncoder,
    SpatialEncoderConfig,
    normalize_imagenet,
)
from benchmark.reference.ops.grid_sample import grid_sample_nearest

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PixelNeRFConfig:
    num_freqs: int = 6
    freq_factor: float = 6.28
    include_input: bool = True
    encoder: SpatialEncoderConfig = dc_field(
        default_factory=SpatialEncoderConfig)
    n_blocks: int = 5
    d_hidden: int = 512
    combine_layer: int = 3
    # activation/matmul dtype ("float32" | "bfloat16"); params stay f32
    compute_dtype: str = "float32"

    @property
    def poscode(self) -> PositionalEncoding:
        return PositionalEncoding(self.num_freqs, 3, self.freq_factor,
                                  self.include_input)

    @property
    def depthcode(self) -> PositionalEncoding:
        return PositionalEncoding(self.num_freqs, 1, self.freq_factor,
                                  self.include_input)

    @property
    def d_in(self) -> int:
        return self.poscode.d_out + self.depthcode.d_out + 3

    @property
    def d_latent(self) -> int:
        return self.encoder.latent_size


class PixelNeRF(nn.Module):

    def __init__(self, cfg: PixelNeRFConfig = PixelNeRFConfig()):
        super().__init__()
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r} not in "
                             f"{sorted(COMPUTE_DTYPES)}")
        self.cfg = cfg
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.encoder = SpatialEncoder(cfg.encoder, self.dtype)
        self.mlp = ResnetFC(d_in=cfg.d_in, d_out=4, n_blocks=cfg.n_blocks,
                            d_latent=cfg.d_latent, d_hidden=cfg.d_hidden,
                            combine_layer=cfg.combine_layer, combine_axis=1,
                            dtype=self.dtype)

    def encode(self, images, depths, depths_std, extrinsics, intrinsics,
               train: bool = True, update_stats: bool = False
               ) -> SceneContext:
        """images (SB, NV, H, W, 3) in [0, 1]; depths / depths_std
        (SB, NV, H, W, 1); extrinsics (SB, NV, 4, 4); intrinsics
        (SB, NV, 3, 3). ``train`` normalizes with batch statistics;
        ``update_stats`` also moves the running ones (the train step)."""
        SB, NV, H, W, _ = images.shape
        imgs = normalize_imagenet(images)
        normals = depth_to_normal(depths.reshape(SB * NV, H, W),
                                  intrinsics.reshape(SB * NV, 3, 3)
                                  ).reshape(SB, NV, H, W, 3)
        latent = self.encoder(imgs.reshape(SB * NV, H, W, 3), train=train,
                              update_stats=update_stats)
        latent = latent.reshape((SB, NV) + tuple(latent.shape[1:]))
        intrinsics = intrinsics.to(imgs.dtype)
        return SceneContext(
            latent=latent, depths=depths, depth_stds=depths_std,
            normals=normals, poses=extrinsics,
            focal=torch.stack([intrinsics[..., 0, 0], intrinsics[..., 1, 1]],
                              dim=-1),
            c=intrinsics[..., :2, 2],
            image_wh=torch.tensor([float(W), float(H)], dtype=imgs.dtype,
                                  device=imgs.device),
            feature_padding=self.cfg.encoder.feature_padding)

    def field(self, ctx: SceneContext, xyz, viewdirs):
        """xyz, viewdirs (SB, B, 3) world → (SB, B, 4) f32
        [sigmoid(rgb), relu(sigma)]."""
        cfg = self.cfg
        SB, B, _ = xyz.shape
        NV = ctx.num_views
        xyz_cam = world_to_cam(xyz, ctx.poses)          # (SB, NV, B, 3)
        dirs_cam = rotate_to_cam(viewdirs, ctx.poses)

        uv = uv_to_ndc(project_points(xyz_cam, ctx.focal, ctx.c),
                       ctx.image_wh)
        latent = index_latent(ctx, uv)                  # (SB, NV, B, C)
        ref_depth = grid_sample_nearest(
            ctx.depths.reshape((SB * NV,) + tuple(ctx.depths.shape[2:])),
            uv.reshape(SB * NV, B, 2), "border").reshape(SB, NV, B)
        depth_dist = ref_depth - xyz_cam[..., 2]

        # JAX concatenates in f32 and each Dense casts to the compute
        # dtype; casting the parts first gives the same values in less memory
        dt = self.dtype
        mlp_in = torch.cat([latent.to(dt), cfg.poscode(xyz_cam).to(dt),
                            dirs_cam.to(dt),
                            cfg.depthcode(depth_dist[..., None]).to(dt)],
                           dim=-1)
        out = self.mlp(mlp_in).float()  # composite stays f32
        return torch.cat([torch.sigmoid(out[..., :3]),
                          torch.relu(out[..., 3:4])], dim=-1)
