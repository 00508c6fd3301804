"""VGG19 perceptual loss in torch core (no torchvision).

Port of ``diner_tpu/losses/vgg.py``: the convolutions of torchvision's
``vgg19.features`` named ``conv_{torch index}`` (as the program's), 2×2 max pools before conv 5, 10 and
19, and four feature slices cut before conv 2, 7 and 12 plus the last
ReLU. ``vgg_loss`` computes the convolutions in the model's dtype, takes
per-slice L1 means in f32 with the target features detached, and weights
the slices 1/16, 1/8, 1/4, 1. The network is frozen; the benchmark draws
its weights (``benchmark/weights.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import round_input
from benchmark.reference.nn.spatial_encoder import normalize_imagenet

# (torch layer index, out_channels); max pools sit in the index gaps
VGG19_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
               (14, 256), (16, 256), (19, 512))
POOL_BEFORE = {5, 10, 19}
SLICE_ENDS = {2, 7, 12}  # a slice ends before these convs
SLICE_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class _Conv3x3(nn.Module):
    """One 3×3 conv's parameters: weight (O, I, 3, 3), bias (O,)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))


class VGG19Features(nn.Module):
    """(N, H, W, 3) → the four feature slices (NCHW), computed in the
    input's dtype with f32 parameters cast at use."""

    def __init__(self):
        super().__init__()
        cin = 3
        for idx, ch in VGG19_CONVS:
            self.add_module(f"conv_{idx}", _Conv3x3(cin, ch))
            cin = ch
        self.requires_grad_(False)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        feats = []
        for idx, _ in VGG19_CONVS:
            if idx in POOL_BEFORE:
                x = F.max_pool2d(x, 2, 2)
            if idx in SLICE_ENDS:
                feats.append(x)
            conv = getattr(self, f"conv_{idx}")
            x = torch.relu(F.conv2d(round_input(x),
                                    round_input(conv.weight.to(x.dtype)),
                                    conv.bias.to(x.dtype), padding=1))
        feats.append(x)
        return feats


def vgg_loss(vgg: VGG19Features, pred, target, dtype=torch.float32):
    """Perceptual L1 between feature slices of pred and target (N, H, W, 3)
    in [0, 1]; ``dtype`` is the convolutions' compute dtype."""
    fx = vgg(normalize_imagenet(pred).to(dtype))
    with torch.no_grad():
        fy = vgg(normalize_imagenet(target).to(dtype))
    loss = 0.0
    for w, a, b in zip(SLICE_WEIGHTS, fx, fy):
        loss = loss + w * torch.mean(torch.abs(a.float() - b.float()))
    return loss
