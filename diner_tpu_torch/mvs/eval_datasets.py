"""The MVS test-time dataset and its preprocessing helpers (host-side
numpy, channels-last).

Port-side copy of ``diner_tpu/mvs/eval_datasets.py:35-266`` (reference
``deps/TransMVSNet/datasets/general_eval.py`` and ``preprocess.py``):
pair.txt-driven scene trees (DTU test, Tanks & Temples), per-scene interval
scale, images resized on a base-32 grid to fit (max_h, max_w), one
resolution per scene with ``fix_res``. The BlendedMVS training set
(``MVSBlendedDataset``) belongs to training and is not ported.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from diner_tpu_torch.data.io import (
    read_pfm,
    read_rgb,
    resize_bilinear,
    resize_nearest,
)


# ---------------------------------------------------------------------------
# preprocess.py helpers (deps/TransMVSNet/datasets/preprocess.py:7-73)
# ---------------------------------------------------------------------------

def scale_camera(cam: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Scale a 3×3 intrinsics matrix's focal + principal point."""
    new_cam = np.copy(cam)
    new_cam[0][0] = cam[0][0] * scale
    new_cam[1][1] = cam[1][1] * scale
    new_cam[0][2] = cam[0][2] * scale
    new_cam[1][2] = cam[1][2] * scale
    return new_cam


def scale_image(image: np.ndarray, scale: float = 1.0,
                interpolation: str = "linear") -> np.ndarray:
    h, w = image.shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if interpolation == "linear":
        return resize_bilinear(image, nh, nw)
    if interpolation == "nearest":
        return resize_nearest(image, nh, nw)
    raise ValueError(interpolation)


def scale_mvs_input(images: Sequence[np.ndarray], cams: Sequence[np.ndarray],
                    depth_image: np.ndarray | None = None,
                    scale: float = 1.0, view_num: int = 5):
    """Resize every view's image + intrinsics (preprocess.py:26-39)."""
    new_images = np.array([scale_image(images[v], scale=scale)
                           for v in range(view_num)])
    new_cams = [scale_camera(cams[v], scale=scale) for v in range(view_num)]
    if depth_image is None:
        return new_images, new_cams
    depth_image = scale_image(depth_image, scale=scale,
                              interpolation="nearest")
    # the reference returns the unscaled cams beside a scaled depth here
    # (preprocess.py:39), kept for protocol parity
    return new_images, cams, depth_image


def crop_mvs_input(images: Sequence[np.ndarray], cams: List[np.ndarray],
                   depth_image: np.ndarray | None = None, view_num: int = 5,
                   max_h: int = 1200, max_w: int = 1600,
                   base_image_size: int = 8):
    """Centre-crop to ≤(max_h, max_w), a multiple of base
    (preprocess.py:41-73)."""
    new_images = []
    start_h = start_w = finish_h = finish_w = 0
    for view in range(view_num):
        h, w = images[view].shape[:2]
        new_h = max_h if h > max_h else int(
            math.ceil(h / base_image_size) * base_image_size)
        new_w = max_w if w > max_w else int(
            math.ceil(w / base_image_size) * base_image_size)
        start_h = int(math.ceil((h - new_h) / 2))
        start_w = int(math.ceil((w - new_w) / 2))
        finish_h = start_h + new_h
        finish_w = start_w + new_w
        new_images.append(images[view][start_h:finish_h, start_w:finish_w])
        cams[view][0][2] = cams[view][0][2] - start_w
        cams[view][1][2] = cams[view][1][2] - start_h
    new_images = np.stack(new_images)
    if depth_image is not None:
        depth_image = depth_image[start_h:finish_h, start_w:finish_w]
        return new_images, cams, depth_image
    return new_images, cams


def center_img(img: np.ndarray) -> np.ndarray:
    """Per-channel standardisation (bld_train.py:78-82)."""
    img = img.astype(np.float32)
    var = np.var(img, axis=(0, 1), keepdims=True)
    mean = np.mean(img, axis=(0, 1), keepdims=True)
    return (img - mean) / (np.sqrt(var) + 1e-8)


def _proj_pyramid(proj: np.ndarray) -> Dict[str, np.ndarray]:
    """(V, 2, 4, 4) stage-1 proj → intrinsics ×2/×4 at finer stages."""
    out = {"stage1": proj}
    for stage, mult in (("stage2", 2), ("stage3", 4)):
        p = proj.copy()
        p[:, 1, :2] *= mult
        out[stage] = p
    return out


def read_pair_file(path) -> List:
    """pair.txt → [(ref_view, [src_views...]), ...] (general_eval.py:43-54)."""
    pairs = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            pairs.append((ref_view, src_views))
    return pairs


# ---------------------------------------------------------------------------
# general_eval.py — MVS test-time dataset
# ---------------------------------------------------------------------------

class MVSGeneralEvalDataset:
    """Test loader for pair.txt scene trees (general_eval.py:12-188).

    Yields {imgs (V,H,W,3), proj_matrices {stage: (V,2,4,4)},
    depth_values (D,), filename} with images resized to fit
    (max_h, max_w) on a base-32 grid and a per-sample (or per-scene with
    ``fix_res``) standard resolution.
    """

    def __init__(self, datapath, scans: Sequence[str], mode: str,
                 nviews: int, ndepths: int = 192,
                 interval_scale=1.06, max_h: int = 864, max_w: int = 1152,
                 fix_res: bool = False):
        if mode != "test":
            raise ValueError(f"MVSGeneralEvalDataset is test-only, not {mode!r}")
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h, self.max_w = max_h, max_w
        self.fix_res = fix_res
        self.fix_wh = False
        self._std_hw = None

        if isinstance(interval_scale, float):
            self.interval_scale = {s: interval_scale for s in scans}
        else:
            self.interval_scale = dict(interval_scale)

        self.metas = []
        for scan in scans:
            for ref_view, src_views in read_pair_file(
                    self.datapath / scan / "pair.txt"):
                if len(src_views) > 0:
                    if len(src_views) < self.nviews:
                        src_views = src_views + [src_views[0]] * (
                            self.nviews - len(src_views))
                    self.metas.append((scan, ref_view, src_views, scan))

    def __len__(self):
        return len(self.metas)

    def read_cam_file(self, filename, interval_scale: float):
        """Cam txt with an optional 3rd num_depth field
        (general_eval.py:63-83)."""
        with open(filename) as f:
            lines = [line.rstrip() for line in f.readlines()]
        extrinsics = np.array(" ".join(lines[1:5]).split(),
                              np.float32).reshape(4, 4)
        intrinsics = np.array(" ".join(lines[7:10]).split(),
                              np.float32).reshape(3, 3)
        intrinsics[:2, :] /= 4.0
        fields = lines[11].split()
        depth_min = float(fields[0])
        depth_interval = float(fields[1])
        if len(fields) >= 3:
            num_depth = float(fields[2])
            depth_max = depth_min + int(num_depth) * depth_interval
            depth_interval = (depth_max - depth_min) / self.ndepths
        depth_interval *= interval_scale
        return intrinsics, extrinsics, depth_min, depth_interval

    def scale_mvs_input(self, img, intrinsics, max_w, max_h, base=32):
        """Resize to fit (max_h, max_w) on a base grid
        (general_eval.py:96-113)."""
        h, w = img.shape[:2]
        if h > max_h or w > max_w:
            scale = 1.0 * max_h / h
            if scale * w > max_w:
                scale = 1.0 * max_w / w
            new_w, new_h = scale * w // base * base, scale * h // base * base
        else:
            new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base
        intrinsics = intrinsics.copy()
        intrinsics[0, :] *= 1.0 * new_w / w
        intrinsics[1, :] *= 1.0 * new_h / h
        img = resize_bilinear(img, int(new_h), int(new_w))
        return img, intrinsics

    def _img_path(self, scan: str, vid: int) -> Path:
        post = self.datapath / scan / "images_post" / f"{vid:08d}.jpg"
        return post if post.exists() else (
            self.datapath / scan / "images" / f"{vid:08d}.jpg")

    def __getitem__(self, idx: int) -> Dict:
        scan, ref_view, src_views, scene_name = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj_matrices = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img = read_rgb(self._img_path(scan, vid))
            intrinsics, extrinsics, depth_min, depth_interval = (
                self.read_cam_file(
                    self.datapath / scan / "cams" / f"{vid:08d}_cam.txt",
                    interval_scale=self.interval_scale[scene_name]))
            img, intrinsics = self.scale_mvs_input(
                img, intrinsics, self.max_w, self.max_h)

            if self.fix_res:
                self._std_hw = img.shape[:2]
                self.fix_res = False
                self.fix_wh = True
            if i == 0 and not self.fix_wh:
                self._std_hw = img.shape[:2]

            s_h, s_w = self._std_hw
            c_h, c_w = img.shape[:2]
            if (c_h, c_w) != (s_h, s_w):
                intrinsics[0, :] *= 1.0 * s_w / c_w
                intrinsics[1, :] *= 1.0 * s_h / c_h
                img = resize_bilinear(img, s_h, s_w)

            imgs.append(img)
            pm = np.zeros((2, 4, 4), np.float32)
            pm[0] = extrinsics
            pm[1, :3, :3] = intrinsics
            proj_matrices.append(pm)

            if i == 0:
                depth_values = np.arange(
                    depth_min,
                    depth_interval * (self.ndepths - 0.5) + depth_min,
                    depth_interval, dtype=np.float32)

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": _proj_pyramid(np.stack(proj_matrices)),
            "depth_values": depth_values,
            "filename": scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
        }


# ---------------------------------------------------------------------------
# bld_train.py — BlendedMVS training dataset
# ---------------------------------------------------------------------------

class MVSBlendedDataset:
    """BlendedMVS loader (bld_train.py:8-167).

    Depth interval = (cam-file depth_max − depth_min) / ndepths; validity
    mask = GT depth within [depth_min, depth_min + (ndepths−1)·interval];
    multi-stage nearest pyramids; channels-last images.
    """

    def __init__(self, datapath, listfile, mode: str, nviews: int,
                 ndepths: int = 192, interval_scale: float = 1.0,
                 image_scale: float = 1.0):
        assert mode in ("train", "val", "test")
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.image_scale = image_scale
        scans = [s for s in Path(listfile).read_text().splitlines() if s]
        self.metas = []
        for scan in scans:
            for ref_view, src_views in read_pair_file(
                    self.datapath / scan / "cams" / "pair.txt"):
                if len(src_views) < self.nviews - 1:
                    continue
                self.metas.append((scan, ref_view, src_views))

    def __len__(self):
        return len(self.metas)

    def read_cam_file(self, filename):
        """BlendedMVS cam txt: interval from span / ndepths (bld_train.py:53-70)."""
        with open(filename) as f:
            lines = [line.rstrip() for line in f.readlines()]
        extrinsics = np.array(" ".join(lines[1:5]).split(),
                              np.float32).reshape(4, 4)
        intrinsics = np.array(" ".join(lines[7:10]).split(),
                              np.float32).reshape(3, 3)
        intrinsics[:2, :] /= 4.0
        if self.image_scale != 1.0:
            intrinsics[:2, :] *= self.image_scale
        fields = lines[11].split()
        depth_min = float(fields[0])
        depth_max = float(fields[-1])
        depth_interval = (depth_max - depth_min) / self.ndepths
        return intrinsics, extrinsics, depth_min, depth_interval

    def __getitem__(self, idx: int) -> Dict:
        scan, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj_matrices = [], []
        depth_ms = mask_ms = depth_values = None
        depth_interval = None
        depth_name = None
        for i, vid in enumerate(view_ids):
            img = read_rgb(self.datapath / scan / "blended_images" /
                           f"{vid:08d}.jpg")
            intrinsics, extrinsics, depth_min, depth_interval = (
                self.read_cam_file(self.datapath / scan / "cams" /
                                   f"{vid:08d}_cam.txt"))
            imgs.append(img)
            pm = np.zeros((2, 4, 4), np.float32)
            pm[0] = extrinsics
            pm[1, :3, :3] = intrinsics
            proj_matrices.append(pm)

            if i == 0:
                depth_name = str(self.datapath / scan /
                                 "rendered_depth_maps" / f"{vid:08d}.pfm")
                depth = np.asarray(read_pfm(depth_name)[0], np.float32)
                depth_end = depth_interval * (self.ndepths - 1) + depth_min
                mask = ((depth >= depth_min) & (depth <= depth_end)
                        ).astype(np.float32)
                h, w = depth.shape
                mask_ms = {
                    "stage1": resize_nearest(mask, h // 4, w // 4),
                    "stage2": resize_nearest(mask, h // 2, w // 2),
                    "stage3": mask,
                }
                depth_ms = {
                    "stage1": resize_nearest(depth, h // 4, w // 4),
                    "stage2": resize_nearest(depth, h // 2, w // 2),
                    "stage3": depth,
                }
                depth_max = depth_interval * self.ndepths + depth_min
                depth_values = np.arange(depth_min, depth_max,
                                         depth_interval, dtype=np.float32)

        return {
            "imgs": np.stack(imgs),
            "proj_matrices": _proj_pyramid(np.stack(proj_matrices)),
            "depth": depth_ms,
            "depth_values": depth_values,
            "mask": mask_ms,
            "depth_interval": np.float32(depth_interval),
            "name": depth_name,
        }
