"""The FaceScape dense-keypoint regressor dataset.

Port-side copy of ``diner_tpu/data/facescape_regressor.py`` (reference
``src/data/facescape_regressor.py``): pairs of an RGB view and the 2-D
pixel positions of the subject's dense face vertices projected with the
view's camera, the DenseRegressor's targets.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from diner_tpu_torch.data.facescape import RGBA_FNAME, read_rgba, to_homogeneous


def project_vertices(vertices: np.ndarray, extrinsics: np.ndarray,
                     intrinsics: np.ndarray) -> np.ndarray:
    """World vertices → pixel coordinates (cam_geometry.py:5-33)."""
    v_cam = vertices @ extrinsics[:3, :3].T + extrinsics[:3, 3]
    uv = v_cam @ intrinsics.T
    return uv[:, :2] / uv[:, 2:3]


class FacescapeRegressorDataset:
    def __init__(self, root, stage: str,
                 split_dir: str = "assets/data_splits/facescape",
                 n_repeat: Optional[int] = None, **_):
        self.data_dir = Path(root)
        assert os.path.exists(root), root
        self.stage = stage
        self.rnd = (np.random.default_rng() if stage == "train"
                    else np.random.default_rng(128))
        meta_fpath = Path(split_dir) / f"{stage}_metas_binocular.txt"
        with open(meta_fpath) as f:
            metas = json.load(f)
        if n_repeat is None:
            n_repeat = 5 if stage == "train" else 20
        self.metas = [m for m in metas for _ in range(n_repeat)]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        suffix = "_val" if self.stage == "val" else ""
        view_id = str(self.rnd.choice(np.array(meta["targets" + suffix])))
        scan = self.data_dir / meta["scan_path"]

        rgb, _ = read_rgba(scan / f"view_{int(view_id):05d}" / RGBA_FNAME)
        vertices = np.loadtxt(scan / "face_vertices.npy", dtype=np.float32)
        with open(scan / "cameras.json") as f:
            cams = json.load(f)
        extr = to_homogeneous(
            np.asarray(cams[view_id]["extrinsics"], np.float32))
        intr = np.asarray(cams[view_id]["intrinsics"], np.float32)
        kpts = project_vertices(vertices, extr, intr).astype(np.float32)

        return dict(image=rgb, target_keypoints=kpts,
                    sample_name=f"{scan.parent.name}-{scan.name}-{view_id}")
