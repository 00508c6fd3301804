"""KeypointNeRF pixel losses.

Port of ``diner_tpu/models/keypointnerf/losses.py`` (reference
``src/util/keypointnerf_util.py:202-231``, ``pix_loss``): weighted l1 /
l2 / lp (0.4-power) / top-k-percent pixel losses, and the mask MSE of
``compute_error_nerf`` (:108-200).
"""

from __future__ import annotations

from typing import Dict

import torch


def pix_loss(src, tar, w_losses: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """src/tar: (B, ..., C) images or patches; returns weighted losses.

    Supported keys: "l1", "l2", "lp", "l1topNN", "l2topNN" (NN = percent).
    """
    out = {}
    for k, v in w_losses.items():
        if v <= 0.0:
            continue
        if k == "l1":
            out[k] = v * torch.mean(torch.abs(src - tar))
        elif k == "l2":
            out[k] = v * torch.mean((src - tar) ** 2)
        elif k == "lp":
            out[k] = v * torch.mean((torch.abs(src - tar) + 1e-4) ** 0.4)
        elif k.startswith("l1top") or k.startswith("l2top"):
            ratio = float(k[5:]) / 100.0
            diff = torch.abs(src - tar) if k.startswith("l1") \
                else (src - tar) ** 2
            # per-pixel channel sum, flattened per sample, top-k mean
            per_pix = torch.sum(diff, dim=-1).reshape(src.shape[0], -1)
            k_count = max(int(per_pix.shape[1] * ratio), 1)
            top = torch.sort(per_pix, dim=-1, descending=True)[0]
            out[k] = v * torch.mean(top[:, :k_count])
        else:
            raise KeyError(k)
    return out


def mask_mse(alpha, tar_alpha):
    """Accumulation-vs-mask MSE (compute_error_nerf mask_loss)."""
    return torch.mean((torch.clamp(alpha, 1e-3, 1.0) - tar_alpha) ** 2)
