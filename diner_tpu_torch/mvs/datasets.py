"""The DTU training-protocol MVS dataset (host-side numpy, channels-last).

Port-side copy of ``diner_tpu/mvs/datasets.py`` (reference
``deps/TransMVSNet/datasets/dtu_yao.py``): the fork's quad-grid target /
source camera layout, images ×1/2 nearest and centre-cropped to 512×640,
nearest GT depth / mask pyramids (×1, ×1/2, ×1/4), per-stage projection
matrices ([extrinsics; intrinsics], intrinsics ×2 / ×4 at finer stages) and
the 1.06 interval scale. ``write_prediction`` (and ``val`` / ``test``)
mode takes one light and the 4 quad-grid corners as targets: cameras 10,
30, 6 and 35, the source views DINER reads (``data/dtu.py:SRC_CAM_IDCS``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from diner_tpu_torch.data.dtu import read_cam_file
from diner_tpu_torch.data.io import read_pfm, read_rgb, resize_nearest

INTERVAL_SCALE = 1.06

# the fork's quad-grid target/src ids (dtu_yao.py:27-46)
_TL = [10, 0, 1, 2, 9, 13, 12, 11, 10]
_BL = [30, 27, 26, 25, 31, 45, 46, 47, 29]
_TR = [6, 2, 3, 4, 5, 18, 17, 16, 7]
_BR = [35, 22, 21, 20, 36, 40, 41, 42, 34]


def quad_grid_ids(train: bool):
    tl, bl, tr, br = (_TL, _BL, _TR, _BR) if train else \
        ([_TL[0]], [_BL[0]], [_TR[0]], [_BR[0]])
    targets = tl + bl + tr + br
    srcs = ([[b, t, r] for b, t, r in zip(bl, tr, br)]
            + [[t, r, b] for t, r, b in zip(tl, tr, br)]
            + [[t, b, r] for t, b, r in zip(tl, bl, br)]
            + [[t, b, r] for t, b, r in zip(tl, bl, tr)])
    return targets, srcs


def prepare_img(hr: np.ndarray) -> np.ndarray:
    """1200×1600 → ×1/2 nearest → centre-crop 512×640 (dtu_yao.py:101-113)."""
    h, w = hr.shape[:2]
    ds = resize_nearest(hr, h // 2, w // 2)
    h, w = ds.shape[:2]
    sh, sw = (h - 512) // 2, (w - 640) // 2
    return ds[sh:sh + 512, sw:sw + 640]


def _pyramid(img: np.ndarray) -> Dict[str, np.ndarray]:
    h, w = img.shape[:2]
    return {
        "stage1": resize_nearest(img, h // 4, w // 4),
        "stage2": resize_nearest(img, h // 2, w // 2),
        "stage3": img,
    }


class MVSDTUDataset:
    """Yields {imgs (V,H,W,3), proj_matrices {stage: (V,2,4,4)},
    depth {stage}, mask {stage}, depth_values (D,), depth_interval, dpath}."""

    def __init__(self, datapath, listfile, mode: str, nviews: int = 4,
                 ndepths: int = 192, interval_scale: float = INTERVAL_SCALE):
        if mode not in ("train", "val", "test", "write_prediction"):
            raise ValueError(f"unknown mode {mode!r}")
        if nviews != 4:
            raise ValueError("the quad grid gives 4 views")
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        scans = [s for s in Path(listfile).read_text().split() if s]
        targets, srcs = quad_grid_ids(train=(mode == "train"))
        lights = range(7) if mode == "train" else [3]
        self.metas = [(scan, light, t, s)
                      for scan in scans
                      for t, s in zip(targets, srcs)
                      for light in lights]

    def __len__(self):
        return len(self.metas)

    def read_cam_file(self, path):
        K, E, (dmin, _) = read_cam_file(path)
        with open(path) as f:
            lines = f.readlines()
        interval = float(lines[11].split()[1]) * self.interval_scale
        return K, E, dmin, interval

    def __getitem__(self, idx: int) -> Dict:
        scan, light, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj = [], []
        depth_ms = mask_ms = depth_values = interval = None
        for i, vid in enumerate(view_ids):
            # the images go through prepare_img as the depths do (upstream
            # TransMVSNet; the fork's dtu_yao.py:168-186 keeps them raw)
            img = prepare_img(read_rgb(
                self.datapath / "Rectified" / f"{scan}_train" /
                f"rect_{vid + 1:03d}_{light}_r5000.png"))
            K, E, dmin, interval = self.read_cam_file(
                self.datapath / "Cameras/train" / f"{vid:08d}_cam.txt")
            pm = np.zeros((2, 4, 4), np.float32)
            pm[0] = E
            pm[1, :3, :3] = K
            proj.append(pm)
            imgs.append(img)
            if i == 0:
                mask_hr = read_rgb(self.datapath / "Depths" / scan /
                                   f"depth_visual_{vid:04d}.png")[..., 0]
                mask_hr = (mask_hr * 255.0 > 10).astype(np.float32)
                mask_ms = _pyramid(prepare_img(mask_hr))
                depth_hr = np.asarray(
                    read_pfm(self.datapath / "Depths" / scan /
                             f"depth_map_{vid:04d}.pfm")[0], np.float32)
                depth_ms = _pyramid(prepare_img(depth_hr))
                depth_values = np.arange(
                    dmin, dmin + interval * self.ndepths, interval,
                    dtype=np.float32)[: self.ndepths]

        proj = np.stack(proj)  # (V, 2, 4, 4)
        proj_ms = {"stage1": proj}
        for stage, mult in (("stage2", 2), ("stage3", 4)):
            p = proj.copy()
            p[:, 1, :2] *= mult
            proj_ms[stage] = p

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": proj_ms,
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
            "depth_interval": np.float32(interval),
            "dpath": f"Depths/{scan}/depth_map_{ref_view:04d}.pfm",
        }
