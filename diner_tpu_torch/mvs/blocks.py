"""Conv building blocks of TransMVSNet (channels-first).

Port of ``diner_tpu/mvs/blocks.py``, written as the reference's own
wrappers (``deps/TransMVSNet/models/module.py`` Conv2d / Conv3d /
Deconv3d: ``conv`` + BatchNorm (momentum 0.1, eps 1e-5) + ReLU) so a
reference checkpoint loads by name. The JAX package's channel-free
``TapConvIn1`` / ``TapConvOut1`` are a TPU layout device: here the C_in =
1 and C_out = 1 convolutions are plain ``nn.Conv3d`` on a (B, 1, D, H, W)
view. ``DeconvBnReLU3D`` is ``nn.ConvTranspose3d(k=3, s=2, p=1,
output_padding=1)``, the reference's module; the JAX package computes it
as an interior pad and a VALID convolution with the kernel flipped
(``utils/convert.py`` undoes the flip).
"""

from __future__ import annotations

import torch
from torch import nn


def _bn(dim: int, features: int):
    return (nn.BatchNorm2d if dim == 2 else nn.BatchNorm3d)(
        features, eps=1e-5, momentum=0.1)


class _ConvBnReLU(nn.Module):
    def __init__(self, conv, features: int, bn: bool, relu: bool, dim: int):
        super().__init__()
        self.conv = conv
        self.bn = _bn(dim, features) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


class ConvBnReLU(_ConvBnReLU):
    """2-D conv (+BN, +ReLU). Input (N, C, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 bn: bool = True, relu: bool = True):
        pad = kernel // 2 if padding is None else padding
        super().__init__(nn.Conv2d(in_channels, features, kernel, stride, pad,
                                   bias=not bn), features, bn, relu, 2)


class ConvBnReLU3D(_ConvBnReLU):
    """3-D conv (+BN, +ReLU). Input (N, C, D, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 bn: bool = True, relu: bool = True):
        pad = kernel // 2 if padding is None else padding
        super().__init__(nn.Conv3d(in_channels, features, kernel, stride, pad,
                                   bias=not bn), features, bn, relu, 3)


class DeconvBnReLU3D(_ConvBnReLU):
    """Stride-2 3-D transposed conv (+BN, +ReLU), output exactly 2× input.
    Input (N, C, D, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 bn: bool = True, relu: bool = True):
        super().__init__(nn.ConvTranspose3d(
            in_channels, features, kernel, stride=2, padding=1,
            output_padding=1, bias=not bn), features, bn, relu, 3)
