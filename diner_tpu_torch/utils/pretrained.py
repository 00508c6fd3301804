"""Drop-in discovery of converted pretrained weights.

Port of ``diner_tpu/utils/pretrained.py``. The reference downloads three
weight sets: torchvision's ImageNet ResNet34 (the spatial encoder),
torchvision's ImageNet VGG19 (the perceptual loss) and LPIPS' VGG16 with
its linear calibration (the evaluation suite). ``python -m
diner_tpu_torch.import_pretrained`` (or the JAX package's
``scripts/import_pretrained.py``, which writes the same files) converts the
original ``.pth`` files into ``.npz`` trees in flax layout under
:func:`pretrained_dir`; both packages read the same files. Where a file is
absent each consumer keeps its seeded substitute: a freshly drawn encoder,
the seed-0 VGG19 loss net, the LPIPS proxy (reported as ``lpips_proxy``).

The trees are bridged to the port's modules by ``utils/convert.py``; this
module reads and writes them and grafts ResNet34 into a model.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

# converted artifact file names (written by import_pretrained)
RESNET34_NPZ = "resnet34_imagenet.npz"
VGG19_NPZ = "vgg19_imagenet.npz"
LPIPS_NPZ = "lpips_vgg.npz"

LPIPS_PROXY_NOTE = (
    "uniform-calibration proxy (official LPIPS VGG16+lin weights not "
    "present); values are NOT comparable to reference LPIPS ranges "
    "[0, 0.5] — see docs/PRETRAINED.md for the drop-in runbook"
)


def pretrained_dir() -> Path:
    """Weights directory: $DINER_TPU_PRETRAINED or <repo>/assets/pretrained."""
    env = os.environ.get("DINER_TPU_PRETRAINED")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "assets" / "pretrained"


def save_tree_npz(path, tree) -> None:
    """Save a nested dict of arrays as an npz with '/'-joined keys; tuple
    and list items get '#N' segments."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(f"{prefix}/#{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_tree_npz(path):
    """Inverse of :func:`save_tree_npz` ('#N' segments become tuples)."""
    data = np.load(path)
    tree: Dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def fix(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(tree)


def _maybe(name: str):
    p = pretrained_dir() / name
    return load_tree_npz(p) if p.exists() else None


def load_resnet34_variables() -> Optional[dict]:
    """Converted torchvision resnet34 ``{'params', 'batch_stats'}`` or None."""
    return _maybe(RESNET34_NPZ)


def load_vgg19_loss_params() -> Optional[dict]:
    """Converted VGG19 ``params`` tree for the perceptual loss, or None."""
    t = _maybe(VGG19_NPZ)
    return t["params"] if t else None


def load_lpips_params() -> Optional[dict]:
    """``{'vgg': params, 'lins': tuple}`` for real LPIPS, or None."""
    return _maybe(LPIPS_NPZ)


def load_lpips(device=None):
    """Real LPIPS (VGG16 with its linear calibration) from the converted
    weights on ``device`` (``cuda`` unless the caller asks for the CPU), or
    None where the file is absent."""
    params = load_lpips_params()
    if params is None:
        return None
    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.evaluation.metrics import LPIPSVGG
    from diner_tpu_torch.utils.convert import lpips_to_state_dict
    lp = LPIPSVGG()
    lp.load_state_dict(lpips_to_state_dict(params))
    return lp.to(resolve_device(device))


def lpips_params_or_proxy(device=None):
    """The evaluation suite's default: real LPIPS (:func:`load_lpips`) if
    its weights are present, else ``"proxy"``."""
    lp = load_lpips(device)
    return lp if lp is not None else "proxy"


def load_vgg19(device=None):
    """The perceptual loss's VGG19 (the convolutions its four slices use)
    with the converted ImageNet weights on ``device`` (``cuda`` unless the
    caller asks for the CPU), or None where the file is absent."""
    params = load_vgg19_loss_params()
    if params is None:
        return None
    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.losses.vgg import VGG19_CONVS, VGG19Features
    from diner_tpu_torch.utils.convert import flax_to_state_dict
    used = {f"conv_{idx}" for idx, _ in VGG19_CONVS}  # the loss's slices
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict(
        {"params": {k: v for k, v in params.items() if k in used}}))
    return vgg.to(resolve_device(device))


@torch.no_grad()
def graft_resnet34(model, pretrained: dict):
    """Replace ``model``'s encoder ResNet (a ``PixelNeRF``) with pretrained
    ImageNet weights, in place; returns ``model``.

    The encoder widens conv1's input from 3 to 3 + d_pe channels for the
    padded-ring positional stamp; as the reference does
    (``image_encoder.py:60-86``) the pretrained RGB slice goes into the
    first 3 input channels and the stamp channels keep their fresh
    initialization. Every other ResNet parameter and the BN running
    statistics are replaced.

    Args:
      model: a ``PixelNeRF`` (its ``encoder.resnet``).
      pretrained: ``{'params', 'batch_stats'}`` from ``convert_resnet``.
    """
    from diner_tpu_torch.utils.convert import flax_to_state_dict
    resnet = model.encoder.resnet
    own = resnet.state_dict()
    for key, value in flax_to_state_dict(pretrained).items():
        if key not in own:
            raise KeyError(f"pretrained key {key} not in the encoder")
        dst = own[key]
        if key == "conv1.weight" and dst.shape[1] != value.shape[1]:
            dst[:, :value.shape[1]].copy_(value)
        elif dst.shape != value.shape:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(dst.shape)} vs {tuple(value.shape)}")
        else:
            dst.copy_(value)
    return model
