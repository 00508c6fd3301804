"""Preprocessing: ground-truth depth from meshes (kernel R) and FaceScape's
colour calibration, the port of ``diner_tpu/preprocessing``."""

from diner_tpu_torch.preprocessing.rasterize import rasterize_depth
from diner_tpu_torch.preprocessing.facescape import (
    masked_downsampling,
    color_calibration_affine,
    apply_color_calibration,
)

__all__ = [
    "rasterize_depth",
    "masked_downsampling",
    "color_calibration_affine",
    "apply_color_calibration",
]
