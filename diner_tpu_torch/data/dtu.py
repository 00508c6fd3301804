"""DTU dataset (host-side numpy, channels-last).

Parity target: reference ``src/data/dtu.py`` — 49-camera DTU MVS rig with:
  - world scale 0.7/872 (matches Facescape scale, :21, 43), images ×0.5
  - fixed source views [30, 10, 6, 35] (:48); metas = scans × 49 cams ×
    7 lights (:53-62)
  - intrinsics ×4 (cam files are quarter-res) then ×downsample (:168-169)
  - depth from PFM (half-res, crop rows 44:556 / cols 80:720 → 512×640) or
    TransMVSNet uint16 PNG ×1e-4 un-scaled by 872/0.7 (:96-108)
  - confidence→std affine  σ = −2.5679e−2·conf + 3.2818e−2 (:68-70)
  - camera-sweep extrinsics by spherical interpolation around the
    triangulated rotation center of cams 11/24/18 (:245-340)

Ships the standard MVSNet DTU train/val scan splits (the reference expects
``assets/data_splits/dtu/dtu_{train,val}_all.txt`` which its repo does not
vendor).

Port-side copy of ``diner_tpu/data/dtu.py`` with its own split files; the
debug harnesses (``visualize_item``, ``visualize_camgrid``) plot with
``data/debug.py``.
"""

from __future__ import annotations

from itertools import product
from pathlib import Path
from typing import Dict, List

import numpy as np

from diner_tpu_torch.data.io import read_depth_png, read_pfm, read_rgb, resize_nearest

_SPLIT_DIR = Path(__file__).parent / "splits" / "dtu"

DTU_SCALE_FACTOR = 0.7 / 872.0
SRC_CAM_IDCS = [30, 10, 6, 35]
N_LIGHTS = 7


def conf2std(conf):
    return -2.5679e-2 * conf + 3.2818e-2


def read_cam_file(path):
    """DTU cam txt → (intrinsics (3,3), extrinsics (4,4), [dmin, dmax])."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                               sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                               sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_max = depth_min + float(lines[11].split()[1]) * 192
    return intrinsics, extrinsics, [depth_min, depth_max]


class DTUDataset:
    """Yields channels-last sample dicts (see ``__getitem__``)."""

    def __init__(self, root, stage: str, scale_factor: float = DTU_SCALE_FACTOR,
                 downsample: float = 0.5, depth_fname: str = "TransMVSNet",
                 split_dir=None, exclude_cams=None, only_cams=None):
        self.data_dir = Path(root)
        assert self.data_dir.exists(), root
        self.stage = stage
        self.scale_factor = scale_factor
        self.downsample = downsample
        self.depth_fname = depth_fname

        split_dir = Path(split_dir) if split_dir else _SPLIT_DIR
        split_file = split_dir / f"dtu_{stage}_all.txt"
        self.scan_list = [s for s in split_file.read_text().split() if s]

        self.cam_dict = self._load_cameras()
        self.znear = 400 * scale_factor
        self.zfar = 1500 * scale_factor
        self.src_camids = list(SRC_CAM_IDCS)
        self.nlights = N_LIGHTS
        # Target-camera holdout for single-scan protocols: the reference
        # separates train/val by SCAN (dtu.py:130-140); when only one scan is
        # available, `exclude_cams` (train) / `only_cams` (val) split by
        # target camera instead so eval targets are never supervision
        # targets. Source views (SRC_CAM_IDCS) stay inputs either way.
        if exclude_cams and only_cams:
            raise ValueError("exclude_cams and only_cams are mutually "
                             "exclusive")
        excl = set(exclude_cams or ())
        only = set(only_cams) if only_cams else None
        self.metas = [
            dict(scan_idx=s, cam_idx=c, ref_cam_idcs=self.src_camids,
                 light_idx=l)
            for s, c, l in product(range(len(self.scan_list)),
                                   range(len(self.cam_dict["ids"])),
                                   range(self.nlights))
            if c not in excl and (only is None or c in only)
        ]

    def _load_cameras(self) -> Dict:
        camera_dir = self.data_dir / "Cameras/train"
        cam_paths = [f for f in sorted(camera_dir.iterdir())
                     if f.name.endswith("_cam.txt")]
        ids, extr, intr = [], [], []
        for p in cam_paths:
            K, E, _ = read_cam_file(p)
            K = K.copy()
            K[:2] *= 4  # cam files are quarter-res
            K[:2] *= self.downsample
            E = E.copy()
            E[:3, 3] *= self.scale_factor
            ids.append(int(p.name.replace("_cam.txt", "")))
            extr.append(E)
            intr.append(K)
        return dict(ids=np.asarray(ids),
                    extrinsics=np.stack(extr),
                    intrinsics=np.stack(intr))

    def read_depth(self, path):
        """→ (depth (H,W,1) scaled to world units, mask (H,W,1))."""
        path = Path(path)
        if path.suffix == ".pfm":
            d = np.asarray(read_pfm(path)[0], np.float32)
            H, W = d.shape
            d = resize_nearest(d, H // 2, W // 2)
            d = d[44:556, 80:720]
        elif path.suffix == ".png":
            d = read_depth_png(path)  # meters at TransMVSNet scale
            d = d / DTU_SCALE_FACTOR  # undo the scale used during MVS training
        else:
            raise ValueError(path)
        assert d.shape == (512, 640), d.shape
        if self.downsample != 1:
            d = resize_nearest(d, int(512 * self.downsample),
                               int(640 * self.downsample))
        mask = (d > 0).astype(np.float32)
        d = d * self.scale_factor
        return d[..., None], mask[..., None]

    def __len__(self):
        return len(self.metas)

    def depth_name(self, cam_id: int) -> str:
        return f"depth_map_{cam_id:04d}_{self.depth_fname}.png"

    def sample_name_of(self, idx: int) -> str:
        """The sample's prediction-folder stem WITHOUT loading images.

        Names follow the reference ("{scan}-{cam}", dtu.py:231) and do NOT
        include the light index, so metas collide across the 7 lights —
        used by the eval subset sampler to dedupe (train/loop.py)."""
        meta = self.metas[idx]
        scan = self.scan_list[meta["scan_idx"]]
        return f"{scan}-{int(self.cam_dict['ids'][meta['cam_idx']])}"

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        scan = self.scan_list[meta["scan_idx"]]
        cam_idcs = [meta["cam_idx"]] + meta["ref_cam_idcs"]
        cam_ids = [int(self.cam_dict["ids"][i]) for i in cam_idcs]
        light = meta["light_idx"]

        img_paths = [self.data_dir / "Rectified" / f"{scan}_train" /
                     f"rect_{i + 1:03d}_{light}_r5000.png" for i in cam_ids]
        depth_paths = [self.data_dir / "Depths" / scan / self.depth_name(i)
                       for i in cam_ids[1:]]

        imgs = np.stack([read_rgb(p, self.downsample) for p in img_paths])
        depths, masks = zip(*[self.read_depth(p) for p in depth_paths])
        depths = np.stack(depths)
        masks = np.stack(masks)
        std_paths = [p.parent / p.name.replace(".png", "_conf.png")
                     for p in depth_paths]
        stds = conf2std(np.stack([self.read_depth(p)[0] for p in std_paths]))

        intr = self.cam_dict["intrinsics"][cam_idcs]
        extr = self.cam_dict["extrinsics"][cam_idcs]

        return dict(
            target_rgb=imgs[0],
            target_alpha=np.ones_like(imgs[0, ..., :1]),
            target_extrinsics=extr[0],
            target_intrinsics=intr[0],
            target_view_id=cam_ids[0],
            scan_idx=meta["scan_idx"],
            sample_name=f"{scan}-{cam_ids[0]}",
            src_rgbs=imgs[1:],
            src_alphas=masks,
            src_depths=depths,
            src_depth_stds=stds,
            src_extrinsics=extr[1:],
            src_intrinsics=intr[1:],
            src_view_ids=np.asarray(cam_ids[1:]),
            light_idx=light,
        )

    # -- debug harnesses (reference dtu.py:342-419) -----------------------

    def visualize_item(self, idx: int, show: bool = True, outfile=None):
        from diner_tpu_torch.data.debug import visualize_item
        visualize_item(self[idx], show=show, outfile=outfile)

    def visualize_camgrid(self, show: bool = True, outfile=None):
        from diner_tpu_torch.data.debug import visualize_camgrid
        return visualize_camgrid(self.cam_dict["extrinsics"],
                                 labels=self.cam_dict["ids"], show=show,
                                 outfile=outfile)

    def check_depth_existence(self):
        missing: List[Path] = []
        seen = set()
        for meta in self.metas:
            scan = self.scan_list[meta["scan_idx"]]
            for i in meta["ref_cam_idcs"]:
                cid = int(self.cam_dict["ids"][i])
                p = self.data_dir / "Depths" / scan / self.depth_name(cid)
                if p in seen:
                    continue
                seen.add(p)
                if not p.exists():
                    missing.append(p)
        if missing:
            raise FileNotFoundError("Missing depth files", missing)

    def get_cam_sweep_extrinsics(self, nframes: int, scan_idx=None,
                                 elevation=0.0, radius=0.5) -> np.ndarray:
        """Slerp sweep through cams 11 → 24 → 18 around their triangulated
        rotation center (reference dtu.py:245-340)."""
        from scipy.spatial.transform import Rotation, Slerp

        def pose_of(i):
            return np.linalg.inv(self.cam_dict["extrinsics"][i])

        left, center, right = pose_of(11), pose_of(24), pose_of(18)

        def camray(p):
            return np.concatenate([p[:3, 3], p[:3, 2]])

        def ray_intersections(r1, r2):
            A = np.stack([r1[3:], -r2[3:]], axis=-1)
            b = (r2[:3] - r1[:3])[:, None]
            t = np.linalg.lstsq(A, b, rcond=None)[0].ravel()
            return r1[:3] + r1[3:] * t[0], r2[:3] + r2[3:] * t[1]

        pts = (ray_intersections(camray(left), camray(center))
               + ray_intersections(camray(center), camray(right))
               + ray_intersections(camray(left), camray(right)))
        origin = np.mean(np.stack(pts), axis=0)
        radius = np.mean([np.linalg.norm(origin - p[:3, 3])
                          for p in (left, center, right)])

        t = np.linspace(0, 1, nframes)
        x1 = left[:3, 3] - origin
        x2 = center[:3, 3] - origin
        x3 = right[:3, 3] - origin
        x1, x2, x3 = (v / np.linalg.norm(v) for v in (x1, x2, x3))
        th1 = np.arccos(np.clip(x1 @ x2, -1, 1))
        th2 = np.arccos(np.clip(x2 @ x3, -1, 1))
        centers = np.zeros((nframes, 3))
        first = t < 0.5
        t1 = t[first] * 2
        t2 = t[~first] * 2 - 1
        centers[first] = (np.sin((1 - t1)[:, None] * th1) / np.sin(th1) * x1
                          + np.sin(t1[:, None] * th1) / np.sin(th1) * x2)
        centers[~first] = (np.sin((1 - t2)[:, None] * th2) / np.sin(th2) * x2
                           + np.sin(t2[:, None] * th2) / np.sin(th2) * x3)
        centers = centers * radius + origin

        rots = Rotation.from_matrix(np.stack(
            [left[:3, :3], center[:3, :3], right[:3, :3]]))
        slerp = Slerp([0.0, 0.5, 1.0], rots)
        target_rots = slerp(t).as_matrix()

        poses = np.tile(np.eye(4, dtype=np.float32), (nframes, 1, 1))
        poses[:, :3, :3] = target_rots
        poses[:, :3, 3] = centers
        return np.linalg.inv(poses).astype(np.float32)
