"""TransMVSNet losses and depth metrics.

Port of ``diner_tpu/mvs/loss.py`` (reference ``deps/TransMVSNet/models/
module.py:480-587`` and ``utils.py:268-275``): the masked cross-entropy
against the nearest depth bin (``entropy_loss``), its per-stage weighted
sum (``trans_mvsnet_loss``), the smooth-L1 depth metric, BlendedMVS's
``focal_loss_bld`` metrics, ``info_entropy_loss`` and the ``--mode val``
metrics ``abs_depth_error`` / ``threshold_metric``. Losses are computed in
the probability volume's dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def smooth_l1(pred, target):
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)


def _masked_mean(x, mask):
    return torch.sum(x * mask) / (torch.sum(mask) + 1e-6)


def entropy_loss(prob_volume, depth_gt, mask, depth_values):
    """Masked cross-entropy against the nearest depth bin.

    prob_volume: (B, D, H, W) post-softmax; depth_gt: (B, H, W); mask:
    (B, H, W) bool; depth_values: (B, D) or (B, D, H, W).
    Returns (loss, wta_depth).
    """
    B, D = prob_volume.shape[:2]
    if depth_values.dim() == 2:
        dv = depth_values[:, :, None, None].expand(prob_volume.shape)
    else:
        dv = depth_values
    gt_idx = torch.argmin(torch.abs(dv - depth_gt[:, None]), dim=1)
    gt_idx = torch.round(mask.float() * gt_idx).long()
    gt_onehot = F.one_hot(gt_idx, D).permute(0, 3, 1, 2).to(
        prob_volume.dtype)
    ce = -torch.sum(gt_onehot * torch.log(prob_volume + 1e-6), dim=1)
    maskf = mask.to(prob_volume.dtype)
    valid = torch.sum(maskf, dim=(1, 2)) + 1e-6
    loss = torch.mean(torch.sum(ce * maskf, dim=(1, 2)) / valid)
    wta_idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    wta_depth = torch.gather(dv, 1, wta_idx)[:, 0]
    return loss, wta_depth


def info_entropy_loss(prob_volume, prob_volume_pre, mask):
    """Entropy of the prob volume against its own logits (module.py:480)."""
    lsm = torch.log_softmax(prob_volume_pre, dim=1)
    entropy = -torch.sum(prob_volume * lsm, dim=1)
    maskf = mask.to(prob_volume.dtype)
    valid = torch.sum(maskf, dim=(1, 2)) + 1e-6
    return torch.mean(torch.sum(entropy * maskf, dim=(1, 2)) / valid)


def trans_mvsnet_loss(outputs: Dict, depth_gt_ms: Dict, mask_ms: Dict,
                      dlossw=None):
    """Per-stage entropy loss (×2) weighted by ``dlossw``, the stages in
    sorted order; returns (total_loss, last_stage_depth_loss,
    total_entropy, last_depth_entropy)."""
    total_loss = 0.0
    total_entropy = 0.0
    depth_loss = 0.0
    depth_entropy = None
    for key in sorted(k for k in outputs if k.startswith("stage")):
        stage = outputs[key]
        mask = mask_ms[key] > 0.5
        entro, depth_entropy = entropy_loss(
            stage["prob_volume"], depth_gt_ms[key], mask,
            stage["depth_values"])
        entro = entro * 2.0
        depth_loss = _masked_mean(smooth_l1(depth_entropy, depth_gt_ms[key]),
                                  mask.to(depth_entropy.dtype))
        total_entropy = total_entropy + entro
        if dlossw is not None:
            total_loss = total_loss + dlossw[int(key[5:]) - 1] * entro
        else:
            total_loss = total_loss + entro
    return total_loss, depth_loss, total_entropy, depth_entropy


def focal_loss_bld(outputs: Dict, depth_gt_ms: Dict, mask_ms: Dict,
                   depth_interval, dlossw=None):
    """BlendedMVS variant: the entropy losses and scaled-EPE metrics."""
    total_loss, depth_loss, total_entropy, _ = trans_mvsnet_loss(
        outputs, depth_gt_ms, mask_ms, dlossw)
    last = f"stage{len([k for k in outputs if k.startswith('stage')])}"
    abs_err = torch.abs(depth_gt_ms[last] - outputs[last]["depth"])
    abs_err_scaled = abs_err / (depth_interval * 192.0 / 128.0)
    maskf = (mask_ms[last] > 0.5).to(abs_err.dtype)
    epe = _masked_mean(abs_err_scaled, maskf)
    less1 = _masked_mean((abs_err_scaled < 1.0).to(abs_err.dtype), maskf)
    less3 = _masked_mean((abs_err_scaled < 3.0).to(abs_err.dtype), maskf)
    return total_loss, depth_loss, epe, less1, less3


def abs_depth_error(pred, gt, mask, thresh=None):
    """AbsDepthError_metrics (deps/TransMVSNet/utils.py:268-275)."""
    err = torch.abs(pred - gt)
    maskf = mask.to(pred.dtype)
    if thresh is not None:
        maskf = maskf * (err < thresh)
    return _masked_mean(err, maskf)


def threshold_metric(pred, gt, mask, thresh):
    """Thres_metrics: the share of valid pixels with error > thresh."""
    err = torch.abs(pred - gt)
    return _masked_mean((err > thresh).to(pred.dtype), mask.to(pred.dtype))
