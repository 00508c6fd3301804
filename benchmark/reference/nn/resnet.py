"""ResNet-18/34 feature-pyramid encoder in torch core (no torchvision).

Port of ``diner_tpu/nn/resnet.py``: conv1 7×7/2 → BN → ReLU → maxpool
3×3/2 (−inf padding) → basic-block stages [64, 128, 256, 512]. Public
layout is NHWC as in the JAX package; inside, tensors are NCHW views with
channels-last strides, the layout cuDNN runs fastest.

Convolutions run in the compute dtype with f32 parameters cast at use.
BatchNorm normalizes in f32 and casts its output back to the compute dtype
(``diner_tpu/nn/resnet.py:36-44``), so bf16 activations do not turn f32
after the first BN. ``train=True`` normalizes with batch statistics and
updates the running ones only when ``update_stats=True`` (the train step,
as flax's ``mutable=["batch_stats"]``); ``train=False`` uses the running
ones. Parameter names follow the flax tree, as the program's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import round_input

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_WIDTHS = (64, 128, 256, 512)


class Conv2d(nn.Module):
    """Bias-free convolution; weight (O, I, kH, kW), computed in ``dtype``."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        return F.conv2d(round_input(x.to(self.dtype)),
                        round_input(self.weight.to(self.dtype)),
                        stride=self.stride, padding=self.padding)


def batch_moments(x):
    """Per-channel mean and biased variance of (N, C, H, W) ``x``, in two
    passes."""
    dims = (0, 2, 3)
    mean = x.mean(dim=dims, keepdim=True)
    return mean, (x - mean).square().mean(dim=dims, keepdim=True)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` with
    the output cast to the compute dtype."""

    momentum = 0.9

    def __init__(self, channels, dtype=torch.float32, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.dtype, self.eps = dtype, eps

    def forward(self, x, train: bool, update_stats: bool = False):
        # written out rather than F.batch_norm: batch statistics in two
        # passes, whose sum order does not depend on the CPU thread split,
        # and flax's running update with the biased batch variance
        x = x.float()
        if train:
            mean, var = batch_moments(x)
            if update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean.flatten())
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var.flatten())
        else:
            mean = self.running_mean.view(1, -1, 1, 1)
            var = self.running_var.view(1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1)
        return ((x - mean) * mul + self.bias.view(1, -1, 1, 1)).to(self.dtype)


class BasicBlock(nn.Module):
    """conv3×3-BN-ReLU-conv3×3-BN + identity/downsample skip, ReLU after add."""

    def __init__(self, cin, width, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(width, dtype)
        self.conv2 = Conv2d(width, width, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(width, dtype)
        self.has_downsample = stride != 1 or cin != width
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, width, 1, stride, 0, dtype)
            self.downsample_bn = BatchNorm(width, dtype)

    def forward(self, x, train: bool, update_stats: bool = False):
        bn = (train, update_stats)
        y = torch.relu(self.bn1(self.conv1(x), *bn))
        y = self.bn2(self.conv2(y), *bn)
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x), *bn)
        return torch.relu(x + y)


class ResNetEncoder(nn.Module):
    """Truncated ResNet returning the feature pyramid
    ``[conv1_out, layer1, ..., layer{num_layers-1}]`` (each NHWC)."""

    def __init__(self, in_channels=3, backbone="resnet34", num_layers=4,
                 use_first_pool=True, dtype=torch.float32):
        super().__init__()
        self.num_layers, self.use_first_pool = num_layers, use_first_pool
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, dtype)
        self.bn1 = BatchNorm(64, dtype)
        self.stages = []  # block names per returned pyramid level
        cin = 64
        for stage in range(min(num_layers - 1, 4)):
            names = []
            for blk in range(STAGE_BLOCKS[backbone][stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                names.append(f"layer{stage + 1}_{blk}")
                self.add_module(names[-1], BasicBlock(
                    cin, STAGE_WIDTHS[stage], stride, dtype))
                cin = STAGE_WIDTHS[stage]
            self.stages.append(names)

    def forward(self, x, train: bool = True, update_stats: bool = False):
        bn = (train, update_stats)
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last strides
        x = torch.relu(self.bn1(self.conv1(x), *bn))
        latents = [x]
        for stage, names in enumerate(self.stages):
            if stage == 0 and self.use_first_pool:
                x = F.max_pool2d(x, 3, 2, 1)  # pads with −inf, as flax
            for name in names:
                x = getattr(self, name)(x, *bn)
            latents.append(x)
        return [t.permute(0, 2, 3, 1) for t in latents]
