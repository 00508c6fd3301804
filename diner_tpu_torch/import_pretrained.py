"""Convert the reference's pretrained ``.pth`` weights into drop-in ``.npz``
trees, the port's counterpart of ``scripts/import_pretrained.py``.

It reads the same files and writes the same trees, so either package picks
them up. Expected input files (the torchvision / lpips release names):

  resnet34-b627a593.pth   torchvision ImageNet ResNet34 (the encoder)
  vgg19-dcbb9e9d.pth      torchvision ImageNet VGG19 (the perceptual loss)
  vgg16-397923af.pth      torchvision ImageNet VGG16 (LPIPS backbone)
  lpips_vgg_v0.1.pth      lpips package lpips/weights/v0.1/vgg.pth

Usage (from the repository root; no GPU needed):

    python -m diner_tpu_torch.import_pretrained [--weights-dir DIR]

``DIR`` defaults to ``$DINER_TPU_PRETRAINED`` or ``assets/pretrained/``.
See docs/PRETRAINED.md for the runbook.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.utils import pretrained as P
from diner_tpu_torch.utils.convert import (convert_resnet,
                                           convert_vgg19_features,
                                           load_lpips_weights)


def _load_sd(path: Path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: np.asarray(v) for k, v in sd.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "diner_tpu_torch.import_pretrained")
    ap.add_argument("--weights-dir", type=Path, default=None,
                    help="directory holding the original .pth files and "
                         "receiving the converted .npz trees "
                         "(default: $DINER_TPU_PRETRAINED or "
                         "assets/pretrained)")
    args = ap.parse_args(argv)
    wdir = args.weights_dir or P.pretrained_dir()
    wdir.mkdir(parents=True, exist_ok=True)
    converted = []

    src = wdir / "resnet34-b627a593.pth"
    if src.exists():
        tree = convert_resnet(_load_sd(src), num_layers=4,
                              backbone_blocks=(3, 4, 6, 3))
        P.save_tree_npz(wdir / P.RESNET34_NPZ, tree)
        converted.append(P.RESNET34_NPZ)

    src = wdir / "vgg19-dcbb9e9d.pth"
    if src.exists():
        P.save_tree_npz(wdir / P.VGG19_NPZ,
                        convert_vgg19_features(_load_sd(src)))
        converted.append(P.VGG19_NPZ)

    vgg16 = wdir / "vgg16-397923af.pth"
    lins = wdir / "lpips_vgg_v0.1.pth"
    if vgg16.exists() and lins.exists():
        P.save_tree_npz(wdir / P.LPIPS_NPZ,
                        load_lpips_weights(_load_sd(vgg16), _load_sd(lins)))
        converted.append(P.LPIPS_NPZ)

    if converted:
        print(f"converted into {wdir}: {', '.join(converted)}")
    else:
        print(f"no recognized .pth files in {wdir} — expected any of: "
              "resnet34-b627a593.pth, vgg19-dcbb9e9d.pth, "
              "vgg16-397923af.pth + lpips_vgg_v0.1.pth")
    return converted


if __name__ == "__main__":
    main()
