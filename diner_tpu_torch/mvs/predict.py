"""TransMVSNet inference: the model from a checkpoint and the depth-map
writer DINER's data layer reads.

Port of ``diner_tpu/mvs/train.py:106-170`` (``write_prediction``, reference
``deps/TransMVSNet/train.py:152-208``).
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
    """Load TransMVSNet weights into ``model``: from a port checkpoint
    directory (``step_*``, written by ``mvs/train.py``; its model state
    dict) or from a reference TransMVSNet checkpoint (the trainer's
    ``{"model": …}`` or a bare state dict, DDP ``module.`` prefix or not)
    through ``utils/convert.py:transmvsnet_reference_state_dict``. Both
    hold tensors, numbers and dicts only, so they are read with
    ``weights_only=True``."""
    from diner_tpu_torch.train.checkpoint import STATE_FILE, load_state
    from diner_tpu_torch.utils.convert import transmvsnet_reference_state_dict
    if (Path(path) / STATE_FILE).is_file():
        model.load_state_dict(load_state(path)["model"])
        return model
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(transmvsnet_reference_state_dict(
        blob, model.state_dict()))
    return model


def create_model(cfg, ckpt, device, dtype=torch.float32):
    """A ``TransMVSNet`` computing in ``dtype``, in eval mode on
    ``device``: the checkpoint's weights, or a draw from seed 0 (with a
    note on stderr) without one."""
    from diner_tpu_torch.mvs.model import TransMVSNet
    torch.manual_seed(0)
    model = TransMVSNet(cfg, dtype=dtype)
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
        depth = out["depth"][0].float().cpu().numpy() / depth_scale
        conf = out["photometric_confidence"][0].float().cpu().numpy()
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

