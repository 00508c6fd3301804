"""Pixel-space losses.

Port of ``diner_tpu/losses/basic.py``: the MSE ray loss and the antibias
loss, a 2^n average pool of both images followed by L1 (it penalizes
low-frequency colour shift). Images are (N, H, W, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def antibias_loss(pred, target, n_downsampling: int = 3):
    """pred/target (N, H, W, 3): 2**n_downsampling-fold average pool
    (no padding, as flax's ``avg_pool``), then L1."""
    k = 2 ** n_downsampling
    p = F.avg_pool2d(pred.permute(0, 3, 1, 2), k, k)
    t = F.avg_pool2d(target.permute(0, 3, 1, 2), k, k)
    return l1_loss(p, t)
