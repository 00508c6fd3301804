"""Multiface MVS dataset (host-side numpy, channels-last).

Parity target: ``deps/TransMVSNet/datasets/multiface.py`` — converts the
DINER Multiface metas into leave-one-out MVS samples (each of the 4
reference cameras takes a turn as the MVS reference view, the other 3 are
sources), loads gamma-corrected white-background images, builds uniform
depth hypotheses in [znear, zfar] = [0.5, 1.5], and scales intrinsics per
stage by the exact (W//k)/W ratios the reference uses. Port of
``diner_tpu/mvs/multiface_dataset.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from diner_tpu_torch.data.io import read_depth_png, read_rgb, resize_nearest
from diner_tpu_torch.data.multiface import (
    _to_homogeneous,
    gamma_correct,
    generate_metas,
    load_krt,
)


def build_multiface_mvs_metas(diner_metas: List[dict], nviews: int = 4
                              ) -> List[dict]:
    """DINER metas → leave-one-out MVS metas (multiface.py:44-84).

    One group of ``nviews`` samples per unique (subject, sequence, frame):
    each reference camera becomes the MVS target once, the remaining
    cameras are its sources.
    """
    metas = []
    processed = set()
    sample_idx = 0
    for meta in diner_metas:
        sp = Path(meta["scan_path"])
        scan_identifier = str(sp.parents[1] / sp.name)
        if scan_identifier in processed:
            continue
        processed.add(scan_identifier)
        ref_ids = meta["ref_ids"]
        assert nviews == len(ref_ids)
        for i in range(nviews):
            metas.append(dict(
                idx=sample_idx,
                scan_path=meta["scan_path"],
                target_ids=ref_ids[i],
                ref_ids=ref_ids[:i] + ref_ids[i + 1:],
            ))
            sample_idx += 1
    return metas


class MVSMultifaceDataset:
    """Yields {imgs (V,H,W,3), proj_matrices {stage: (V,2,4,4)},
    depth {stage}, mask {stage}, depth_values (D,), depth_interval, dpath}.

    znear/zfar = 0.5/1.5 (multiface.py:20-21); depth hypotheses are a
    uniform linspace (not cam-file driven — Multiface has no MVS cam
    files, multiface.py:227).
    """

    znear = 0.5
    zfar = 1.5

    def __init__(self, datapath, mode: str, nviews: int = 4,
                 ndepths: int = 192, downsample_factor: float = 0.125,
                 split_config=None, meta_dir=None):
        assert mode in ("train", "val", "test", "write_prediction")
        assert nviews == 4
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.downsample_factor = downsample_factor

        stages = ["train"] if mode in ("train", "write_prediction") \
            else ["val"]
        diner_metas: List[dict] = []
        for stage in stages:
            cache = None
            if meta_dir is not None and split_config is not None:
                cache = (Path(meta_dir) /
                         f"{stage}_{Path(split_config).stem}.txt")
            if cache is not None and cache.exists():
                with open(cache) as f:
                    diner_metas += json.load(f)
            else:
                with open(split_config) as f:
                    cfg = json.load(f)
                cfg = cfg["train"] if stage == "train" else cfg["val"]
                diner_metas += generate_metas(self.datapath, cfg)
        self.metas = build_multiface_mvs_metas(diner_metas, nviews)

    def __len__(self):
        return len(self.metas)

    def read_img(self, p) -> np.ndarray:
        img = read_rgb(p)[..., :3]
        return np.clip(gamma_correct(img), 0, 1).astype(np.float32)

    @staticmethod
    def imgpath_to_dpath(p: Path) -> Path:
        return p.parents[3] / "depths" / p.relative_to(p.parents[2]).parent \
            / (p.stem + ".png")

    @staticmethod
    def imgpath_to_apath(p: Path) -> Path:
        return p.parents[3] / "masks" / p.relative_to(p.parents[2])

    def _multiscale(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        h, w = x.shape
        return {
            "stage1": resize_nearest(x, h // 4, w // 4),
            "stage2": resize_nearest(x, h // 2, w // 2),
            "stage3": x,
        }

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        target_id = meta["target_ids"]
        ref_ids = list(meta["ref_ids"])
        scan_path = Path(meta["scan_path"])
        subject = scan_path.parents[3].name
        seq = scan_path.parents[1].name
        frame = scan_path.stem

        view_ids = [target_id] + ref_ids
        cam_dict = load_krt(self.datapath / subject / "KRT")

        imgs, proj_matrices = [], []
        depth_ms = mask_ms = depth_values = None
        dmap_path = None
        for i, vid in enumerate(view_ids):
            img_path = (self.datapath / subject / "images" / seq / vid /
                        f"{frame}.png")
            extrinsics = _to_homogeneous(cam_dict[vid]["extrin"]).copy()
            extrinsics[:3, 3] /= 1000.0  # mm → m
            intrinsics = cam_dict[vid]["intrin"].astype(np.float32).copy()

            img = self.read_img(img_path)
            mask = read_rgb(self.imgpath_to_apath(img_path))[..., :1]
            H, W = img.shape[:2]
            h = int((H * self.downsample_factor) // 32 * 32)
            w = int((W * self.downsample_factor) // 32 * 32)
            img = _resize_rgb_area(img, h, w)
            mask = resize_nearest(mask, h, w)
            intrinsics[0] *= w / W
            intrinsics[1] *= h / H
            img = np.where(mask < 1, 1.0, img).astype(np.float32)

            if i == 0:
                dmap_path = self.imgpath_to_dpath(img_path)
                depth = read_depth_png(dmap_path)
                depth = resize_nearest(depth, h, w)
                mask_ms = self._multiscale(mask[..., 0])
                depth_ms = self._multiscale(depth)
                depth_values = np.linspace(self.znear, self.zfar,
                                           self.ndepths, dtype=np.float32)

            pm = np.zeros((2, 4, 4), np.float32)
            pm[0] = extrinsics
            pm[1, :3, :3] = intrinsics
            proj_matrices.append(pm)
            imgs.append(img)

        imgs = np.stack(imgs)
        H, W = imgs.shape[1:3]
        proj = np.stack(proj_matrices)
        # stage scaling by exact integer-division ratios (multiface.py:272-287)
        out_proj = {}
        for stage, k in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
            p = proj.copy()
            p[:, 1, 0, :] *= (W // k) / W
            p[:, 1, 1, :] *= (H // k) / H
            out_proj[stage] = p

        return {
            "imgs": imgs,
            "dpath": str(dmap_path.relative_to(self.datapath)),
            "proj_matrices": out_proj,
            "depth": depth_ms,
            "depth_values": depth_values,
            "depth_interval": np.float32(depth_values[1] - depth_values[0]),
            "mask": mask_ms,
        }


def _resize_rgb_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area (box) downsample, the reference's cv2.INTER_AREA for
    integer-ratio shrinks (multiface.py:212); falls back to PIL BILINEAR
    otherwise, matching our DINER loader."""
    H, W = img.shape[:2]
    if H % h == 0 and W % w == 0:
        fh, fw = H // h, W // w
        return img.reshape(h, fh, w, fw, -1).mean(axis=(1, 3)).astype(
            np.float32)
    from PIL import Image
    return np.asarray(Image.fromarray(
        (np.clip(img, 0, 1) * 255).astype(np.uint8)).resize(
        (w, h), Image.BILINEAR), np.float32) / 255.0
