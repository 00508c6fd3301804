"""Pixel-aligned spatial image encoder.

Port of ``diner_tpu/nn/spatial_encoder.py``: the input is edge-padded by
``image_padding`` px and stamped with a positional encoding on the padded
ring (zero inside the image), run through the truncated ResNet, and every
pyramid level is resized (bilinear, align_corners=True) to conv1's
resolution and concatenated along channels. NHWC in and out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.nn.positional_encoding import PositionalEncoding
from benchmark.reference.nn.resnet import ResNetEncoder
from benchmark.reference.utils.resize import resize_bilinear_align_corners

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class SpatialEncoderConfig:
    backbone: str = "resnet34"
    num_layers: int = 4
    use_first_pool: bool = True
    image_padding: int = 64
    padding_pe: int = 4  # num_freqs of the ring PE; < 0 disables

    @property
    def latent_size(self) -> int:
        return [0, 64, 128, 256, 512, 1024][self.num_layers]

    @property
    def feature_padding(self) -> int:
        # conv1 has stride 2; the latent canvas keeps half the image padding
        if self.image_padding % 2:
            raise ValueError("image_padding must be even")
        return self.image_padding // 2

    @property
    def uses_pe(self) -> bool:
        return self.padding_pe >= 0 and self.feature_padding > 0

    @property
    def pe(self) -> PositionalEncoding:
        return PositionalEncoding(num_freqs=self.padding_pe, d_in=2,
                                  freq_factor=math.pi, include_input=True)


def pad_ring_pe(H: int, W: int, padding: int, num_freqs: int,
                dtype=torch.float32, device=None):
    """(H + 2p, W + 2p, d_pe) PE stamp, zero strictly inside the image."""
    pe = PositionalEncoding(num_freqs=num_freqs, d_in=2,
                            freq_factor=math.pi, include_input=True)
    ys = torch.linspace(-1.0, 1.0, H + 2 * padding, dtype=dtype,
                        device=device)
    xs = torch.linspace(-1.0, 1.0, W + 2 * padding, dtype=dtype,
                        device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")  # (H+2p, W+2p)
    stamp = pe(torch.stack([gx, gy], dim=-1))
    if padding <= 0:
        return torch.zeros_like(stamp)
    ring = torch.ones_like(stamp[..., :1])
    ring[padding:-padding, padding:-padding] = 0.0
    return stamp * ring


class SpatialEncoder(nn.Module):
    """imgs (N, H, W, 3), ImageNet-normalized → latent (N, Hl, Wl, C)."""

    def __init__(self, cfg: SpatialEncoderConfig = SpatialEncoderConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        in_ch = 3 + (cfg.pe.d_out if cfg.uses_pe else 0)
        self.resnet = ResNetEncoder(in_ch, cfg.backbone, cfg.num_layers,
                                    cfg.use_first_pool, dtype)

    def forward(self, imgs, train: bool = True, update_stats: bool = False):
        cfg = self.cfg
        N, H, W, _ = imgs.shape
        p = cfg.image_padding
        x = imgs.permute(0, 3, 1, 2)
        if p > 0:
            x = F.pad(x, (p, p, p, p), mode="replicate")
        if cfg.uses_pe:
            stamp = pad_ring_pe(H, W, p, cfg.padding_pe, imgs.dtype,
                                imgs.device)
            x = torch.cat([x, stamp.permute(2, 0, 1)[None].expand(
                N, -1, -1, -1)], dim=1)
        latents = self.resnet(x.permute(0, 2, 3, 1).contiguous(), train,
                              update_stats)
        out_h, out_w = latents[0].shape[1:3]
        return torch.cat([resize_bilinear_align_corners(t, out_h, out_w)
                          for t in latents], dim=-1)


def normalize_imagenet(rgb):
    """ImageNet normalization of (..., 3) RGB in [0, 1]."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=rgb.dtype, device=rgb.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=rgb.dtype, device=rgb.device)
    return (rgb - mean) / std
