"""Multiface dataset (host-side numpy, channels-last).

Parity target: reference ``src/data/multiface.py`` — Meta-RealityLab face
captures:
  - KRT text camera parser (:112-132)
  - meta auto-generation: pick the real cameras nearest the split config's
    ideal reference centers, filter targets by the frustum planes spanned by
    the reference ring (max 10 cm outside), cache metas as JSON (:134-248)
  - gamma correction with the dataset's color scales (:81-100)
  - uint16 depth ×1e-4; optional conf→std affine clip (:301-311)
  - extrinsics translation mm→m (:338-339)
  - resize to /downsample rounded to a multiple of 32, intrinsics rescaled
    (:341-359); white background under alpha < 1
  - slerp camera sweep through the source ring (:384-431)

The reference's infinite retry-on-exception loop (:269-282, a cluster-FS
workaround) is replaced by a bounded ``retries`` parameter. Port of
``diner_tpu/data/multiface.py``; the depth and mask PNGs it reads are those
``python -m diner_tpu_torch.preprocess_multiface`` writes.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from diner_tpu_torch.data.io import read_depth_png, read_rgb, resize_nearest
from diner_tpu_torch.geometry.cam_paths import Slerp

GAMMA, BLACK, COLOR_SCALE = 2.0, 3.0 / 255.0, (1.4, 1.1, 1.6)


def gamma_correct(img: np.ndarray) -> np.ndarray:
    """Multiface color pipeline (multiface.py:85-100); img (..., 3) in
    [0, 1]."""
    scale = np.asarray(COLOR_SCALE, img.dtype)
    img = img * scale / 1.1
    return np.clip(
        ((1.0 / (1 - BLACK)) * 0.95 * np.clip(img - BLACK, 0, 2))
        ** (1.0 / GAMMA) - 15.0 / 255.0, 0, 2)


def load_krt(path) -> Dict[str, Dict[str, np.ndarray]]:
    """Parse the Multiface KRT file (multiface.py:112-132)."""
    cameras = {}
    with open(path) as f:
        while True:
            name = f.readline()
            if name == "":
                break
            intrin = [[float(x) for x in f.readline().split()]
                      for _ in range(3)]
            dist = [float(x) for x in f.readline().split()]
            extrin = [[float(x) for x in f.readline().split()]
                      for _ in range(3)]
            f.readline()
            cameras[name.rstrip("\n")] = {
                "intrin": np.asarray(intrin, np.float32),
                "dist": np.asarray(dist, np.float32),
                "extrin": np.asarray(extrin, np.float32),
            }
    return cameras


def _to_homogeneous(e34: np.ndarray) -> np.ndarray:
    out = np.zeros(e34.shape[:-2] + (4, 4), np.float32)
    out[..., :3, :] = e34
    out[..., 3, 3] = 1.0
    return out


def generate_metas(data_dir: Path, split_config: dict) -> List[dict]:
    """Meta generation: nearest-to-ideal reference ring + frustum filter
    (multiface.py:142-248)."""
    metas = []
    sample_idx = 0
    for subj in split_config["subjects"]:
        krt = load_krt(data_dir / subj / "KRT")
        cam_names = np.array(sorted(krt.keys()))
        extr = np.stack([_to_homogeneous(krt[n]["extrin"]) for n in cam_names])
        centers = -np.einsum("nji,nj->ni", extr[:, :3, :3], extr[:, :3, 3])
        dirs = extr[:, 2, :3]

        origin = np.array([[0, 0, 1000.0]])
        ideal = np.asarray(split_config["ref_centers"],
                           np.float64).reshape(-1, 3)
        if subj == "m--20190529--1004--5067077--GHS":  # dataset quirk
            beta = np.pi * 4 / 6
            rot_y = np.array([[np.cos(beta), 0, np.sin(beta)],
                              [0, 1, 0],
                              [-np.sin(beta), 0, np.cos(beta)]])
            ideal = (rot_y @ (ideal - origin).T).T + origin

        dists = np.linalg.norm(ideal[:, None] - centers[None], axis=-1)
        ref_idcs = np.argsort(dists, axis=1)[:, 0]
        ref_centers = centers[ref_idcs]
        ref_dirs = dirs[ref_idcs]
        ref_names = cam_names[ref_idcs].tolist()

        normals = np.cross(ref_centers[[0, 1, 2, 3]] - ref_centers[[1, 2, 3, 0]],
                           ref_dirs[[0, 1, 2, 3]] + ref_dirs[[1, 2, 3, 0]])
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        inside = np.sum((centers[None] - ref_centers[:4, None]) *
                        normals[:, None], axis=-1)
        inside = np.all(inside > -100, axis=0)  # ≤10 cm outside any plane
        inside[ref_idcs] = False
        target_names = cam_names[inside].tolist()

        seq_paths = [p for p in sorted((data_dir / subj / "images").iterdir())
                     if p.name in split_config["sequences"]]
        for seq_path in seq_paths:
            for target in target_names:
                for frame in sorted((seq_path / target).iterdir()):
                    metas.append(dict(
                        idx=sample_idx,
                        scan_path=str(frame.relative_to(data_dir)),
                        target_id=target,
                        ref_ids=ref_names))
                    sample_idx += 1
    return metas


class MultifaceDataset:
    znear = 0.5
    zfar = 1.5

    def __init__(self, root, stage: str, model: str = "DINER",
                 downsample: int = 8, split_config=None, meta_dir=None,
                 depth_std_suffix: Optional[str] = None,
                 subject_filter=None, sequence_filter=None,
                 target_filter=None, retries: int = 3):
        self.data_dir = Path(root)
        assert os.path.exists(root), root
        self.stage = stage
        self.model = model
        self.downsample = int(downsample)
        self.depth_std_suffix = depth_std_suffix
        self.retries = retries
        self.nsource = 4

        split_config = Path(split_config) if split_config else None
        cache = None
        if meta_dir and split_config is not None:
            cache = Path(meta_dir) / f"{stage}_{split_config.stem}.txt"
        if cache is not None and cache.exists():
            with open(cache) as f:
                metas = json.load(f)
        else:
            with open(split_config) as f:
                cfg = json.load(f)
            cfg = cfg["train"] if stage == "train" else cfg["val"]
            metas = generate_metas(self.data_dir, cfg)
            if cache is not None:
                cache.parent.mkdir(parents=True, exist_ok=True)
                with open(cache, "w") as f:
                    json.dump(metas, f, indent="\t")

        if subject_filter:
            metas = [m for m in metas
                     if any(s in m["scan_path"] for s in subject_filter)]
        if sequence_filter:
            metas = [m for m in metas
                     if any(s in m["scan_path"] for s in sequence_filter)]
        if target_filter:
            metas = [m for m in metas
                     if any(t == m["target_id"] for t in target_filter)]
        self.metas = metas

    def __len__(self):
        return len(self.metas)

    @staticmethod
    def _img_to_depth_path(p: Path) -> Path:
        return p.parents[3] / "depths" / p.relative_to(p.parents[2]).parent \
            / (p.stem + ".png")

    @staticmethod
    def _img_to_alpha_path(p: Path) -> Path:
        return p.parents[3] / "masks" / p.relative_to(p.parents[2])

    def _read_img(self, p) -> np.ndarray:
        return np.clip(gamma_correct(read_rgb(p)[..., :3]), 0, 1)

    def __getitem__(self, idx: int) -> Dict:
        last_err = None
        for _ in range(max(self.retries, 1)):
            try:
                return self._load(idx)
            except Exception as e:  # bounded retry (reference loops forever)
                last_err = e
                time.sleep(0.1)
        raise last_err

    def _load(self, idx: int) -> Dict:
        meta = self.metas[idx]
        source_ids = meta["ref_ids"][2:]
        target_id = meta["target_id"]
        scan_path = Path(meta["scan_path"])
        subject = scan_path.parents[3].name
        seq = scan_path.parents[1].name
        frame = scan_path.stem

        target_img_path = self.data_dir / scan_path
        src_img_paths = [self.data_dir / subject / "images" / seq / sid /
                         f"{frame}.png" for sid in source_ids]

        target_rgb = self._read_img(target_img_path)
        target_alpha = read_rgb(self._img_to_alpha_path(target_img_path))[..., :1]

        rgbs, alphas, depths, stds = [], [], [], []
        for p in src_img_paths:
            rgbs.append(self._read_img(p))
            alphas.append(read_rgb(self._img_to_alpha_path(p))[..., :1])
            d = read_depth_png(self._img_to_depth_path(p))[..., None]
            depths.append(d)
            if self.depth_std_suffix is None:
                std = np.full_like(d, 1e-3)
            else:
                conf = read_depth_png(
                    self._img_to_depth_path(p).with_name(
                        self._img_to_depth_path(p).stem
                        + self.depth_std_suffix))[..., None]
                std = np.clip(-1.582e-2 * conf + 1.649e-2, 0, None)
            std[d == 0] = 0
            stds.append(std)

        src_rgbs = np.stack(rgbs)
        src_alphas = np.stack(alphas)
        src_depths = np.stack(depths)
        src_depth_stds = np.stack(stds)

        # white background where alpha < 1
        src_rgbs = np.where(src_alphas < 1, 1.0, src_rgbs)
        target_rgb = np.where(target_alpha < 1, 1.0, target_rgb)

        cam_dict = load_krt(self.data_dir / subject / "KRT")
        t_extr = _to_homogeneous(cam_dict[target_id]["extrin"])
        t_intr = cam_dict[target_id]["intrin"].copy()
        s_extr = np.stack([_to_homogeneous(cam_dict[s]["extrin"])
                           for s in source_ids])
        s_intr = np.stack([cam_dict[s]["intrin"] for s in source_ids]).copy()
        t_extr[:3, 3] /= 1000.0  # mm → m
        s_extr[:, :3, 3] /= 1000.0

        H, W = target_rgb.shape[:2]
        h = int((H / self.downsample) // 32 * 32)
        w = int((W / self.downsample) // 32 * 32)
        if (h, w) != (H, W):
            from PIL import Image

            def resize_rgb(x):
                return np.asarray(Image.fromarray(
                    (np.clip(x, 0, 1) * 255).astype(np.uint8)).resize(
                    (w, h), Image.BILINEAR), np.float32) / 255.0

            target_rgb = resize_rgb(target_rgb)
            src_rgbs = np.stack([resize_rgb(x) for x in src_rgbs])
            target_alpha = resize_nearest(target_alpha, h, w)
            src_alphas = np.stack([resize_nearest(a, h, w)
                                   for a in src_alphas])
            src_depths = np.stack([resize_nearest(d, h, w)
                                   for d in src_depths])
            src_depth_stds = np.stack([resize_nearest(s, h, w)
                                       for s in src_depth_stds])
            t_intr[0] *= w / W
            t_intr[1] *= h / H
            s_intr[:, 0] *= w / W
            s_intr[:, 1] *= h / H

        return dict(
            target_rgb=target_rgb,
            target_alpha=target_alpha,
            target_extrinsics=t_extr,
            target_intrinsics=t_intr,
            target_view_id=int(target_id),
            scan_idx=0,
            sample_name=f"{subject}-{seq}-{frame}-{target_id}-"
                        f"{'-'.join(source_ids)}",
            frame=frame,
            src_rgbs=src_rgbs,
            src_depths=src_depths,
            src_depth_stds=src_depth_stds,
            src_alphas=src_alphas,
            src_extrinsics=s_extr,
            src_intrinsics=s_intr,
            src_view_ids=np.asarray([int(s) for s in source_ids]),
        )

    # -- debug harnesses (reference multiface.py:433+) --------------------

    def visualize_item(self, idx: int, show: bool = True, outfile=None):
        from diner_tpu_torch.data.debug import visualize_item
        visualize_item(self[idx], show=show, outfile=outfile)

    def visualize_camgrid(self, i: int = 0, show: bool = True,
                          outfile=None):
        from diner_tpu_torch.data.debug import visualize_camgrid
        scan_path = Path(self.metas[i]["scan_path"])
        subject = scan_path.parents[3].name
        krt = load_krt(self.data_dir / subject / "KRT")
        names = sorted(krt.keys())
        extr = np.stack([_to_homogeneous(krt[n]["extrin"]) for n in names])
        return visualize_camgrid(extr, labels=names, show=show,
                                 outfile=outfile)

    def check_depth_existence(self):
        from diner_tpu_torch.data.debug import check_depth_existence

        def paths(meta):
            scan_path = Path(meta["scan_path"])
            subject = scan_path.parents[3].name
            seq = scan_path.parents[1].name
            frame = scan_path.stem
            for sid in meta["ref_ids"][2:]:
                yield self._img_to_depth_path(
                    self.data_dir / subject / "images" / seq / sid /
                    f"{frame}.png")

        check_depth_existence(self.metas, paths)

    def get_cam_sweep_extrinsics(self, nframes: int, scan_idx: int,
                                 **_) -> np.ndarray:
        from scipy.spatial.transform import Rotation

        sample = self[scan_idx]
        src_pose = np.linalg.inv(sample["src_extrinsics"])
        # the reference closes the loop through views 0 and 2; guard for
        # configurations with fewer than 3 source views
        j = min(2, len(src_pose) - 1)
        rots = Rotation.from_matrix(
            np.concatenate([src_pose[:, :3, :3], src_pose[[0], :3, :3],
                            src_pose[[j], :3, :3]], axis=0))
        centers = np.concatenate([src_pose[:, :3, 3], src_pose[[0], :3, 3],
                                  src_pose[[j], :3, 3]], axis=0)
        times = np.linspace(0, 1, len(centers))
        slerp = Slerp(times, rots, centers)
        t = np.linspace(0, 1, nframes + 1)[:-1]
        r, c = slerp(t)
        poses = np.tile(np.eye(4, dtype=np.float64), (nframes, 1, 1))
        poses[:, :3, :3] = r.as_matrix()
        poses[:, :3, 3] = c
        return np.linalg.inv(poses).astype(np.float32)
