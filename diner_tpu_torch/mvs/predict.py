"""TransMVSNet inference: the model from a reference checkpoint, the
depth-map writer DINER's data layer reads, and the depth metrics of
``--mode val``.

Port of ``diner_tpu/mvs/train.py:106-170`` (``write_prediction``, reference
``deps/TransMVSNet/train.py:152-208``) and of the two metrics of
``diner_tpu/mvs/loss.py:105-118`` (reference ``utils.py:268-275``).
``write_prediction`` writes, per sample, ``<dpath stem>_TransMVSNet.png``
(depth ÷ 872/0.7 as a uint16 PNG of 1e-4 units), ``…_conf.png`` (the
photometric confidence, same codec) and ``…_vis.png`` (viridis) under
``outpath``, mirroring the dataset's ``Depths/<scan>/`` tree; with
``facescape_triptych`` it pastes the confidence beside an existing
[gt | pred] image instead. The model's forward for one sample goes through
:func:`run_model`.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.data.io import write_depth_png
from diner_tpu_torch.utils.visual import colorize, save_image

DTU_DEPTH_UNSCALE = 872.0 / 0.7


def load_checkpoint(model, path):
    """Load a reference TransMVSNet checkpoint (the trainer's ``{"model":
    …}`` or a bare state dict, DDP ``module.`` prefix or not) into
    ``model`` through ``utils/convert.py:transmvsnet_reference_state_dict``.
    The reference trainer saves tensors, numbers and dicts only, so the
    file is read with ``weights_only=True``."""
    from diner_tpu_torch.utils.convert import transmvsnet_reference_state_dict
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(transmvsnet_reference_state_dict(
        blob, model.state_dict()))
    return model


def create_model(cfg, ckpt, device):
    """A ``TransMVSNet`` in eval mode on ``device``: the checkpoint's
    weights, or a draw from seed 0 (with a note on stderr) without one."""
    from diner_tpu_torch.mvs.model import TransMVSNet
    torch.manual_seed(0)
    model = TransMVSNet(cfg)
    if ckpt:
        load_checkpoint(model, ckpt)
    else:
        print("no --ckpt: random weights (seed 0)", file=sys.stderr)
    return model.to(device).eval()


def sample_to_device(sample, device):
    """One dataset sample → the model's batch of 1 on ``device``:
    (imgs, proj_matrices, depth_values)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)[None]
    return (t(sample["imgs"]),
            {k: t(v) for k, v in sample["proj_matrices"].items()},
            t(sample["depth_values"]))


def run_model(model, sample, device):
    """The model's outputs for one dataset sample (no gradient)."""
    with torch.no_grad():
        return model(*sample_to_device(sample, device))


def write_prediction(model, dataset, outpath,
                     depth_scale: float = DTU_DEPTH_UNSCALE,
                     mask_output: bool = False,
                     out_suffix: str = "TransMVSNet",
                     facescape_triptych: bool = False, device=None):
    """Run inference over ``dataset`` and write the uint16 depth /
    confidence / visualisation PNGs; returns the depth paths written."""
    device = next(model.parameters()).device if device is None else device
    outpath = Path(outpath)
    written = []
    for i in range(len(dataset)):
        s = dataset[i]
        out = run_model(model, s, device)
        depth = out["depth"][0].cpu().numpy() / depth_scale
        conf = out["photometric_confidence"][0].cpu().numpy()
        if mask_output and s.get("mask") is not None:
            m = s["mask"]["stage3"] > 0.5
            depth = depth * m
            conf = conf * m
        stem = ".".join(s["dpath"].split(".")[:-1])
        dst = outpath / (stem + f"_{out_suffix}.png")
        os.makedirs(dst.parent, exist_ok=True)
        if facescape_triptych and dst.exists():
            # facescape protocol (train.py:183-202): the confidence pasted
            # beside the existing [gt | pred] image → *_gt_pred_conf.png
            from PIL import Image
            gt_img = Image.open(dst)
            conf_q = np.clip(conf / 1e-4, 0, 65535).astype(np.uint16)
            conf_img = Image.fromarray(conf_q)
            trip = Image.new("I", (gt_img.width + conf_img.width,
                                   conf_img.height))
            trip.paste(gt_img, (0, 0))
            trip.paste(conf_img, (gt_img.width, 0))
            trip_path = outpath / (stem + "_gt_pred_conf.png")
            trip.save(trip_path)
            os.remove(dst)
            written.append(str(trip_path))
            continue
        write_depth_png(dst, depth)
        write_depth_png(outpath / (stem + f"_{out_suffix}_conf.png"), conf)
        nz = depth[depth != 0]
        save_image(outpath / (stem + f"_{out_suffix}_vis.png"),
                   colorize(depth, vmin=float(nz.min()) if nz.size else None))
        written.append(str(dst))
    return written


def _masked_mean(x, mask):
    return torch.sum(x * mask) / (torch.sum(mask) + 1e-6)


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
