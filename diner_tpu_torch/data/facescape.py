"""The FaceScape dataset (host-side numpy, channels-last).

Port-side copy of ``diner_tpu/data/facescape.py`` (reference
``src/data/facescape.py``): binocular head captures (2 source views), metas
from JSON split files repeated 5× (train) / 20× (val), view choice from an
unseeded RNG in training and ``default_rng(128)`` in validation, RGBA with
the background forced to white under alpha < 0.5, the depth triptych
[gt | MVS pred | MVS conf] (or the mesh depth, ``depth_type``), the
conf→std affine, znear 1.0 / zfar 2.5, and the camera sweep. The DINER
schema and the KeypointNeRF one (3-D landmarks, face bounds, the ray-box
mask). The fork's hardcoded depth paths are ``depth_root``. The debug
harnesses (``visualize_item``, ``visualize_camgrid``, ``reproject_depth``,
``check_depth_existence``) call ``data/debug.py``.
"""

from __future__ import annotations

import itertools
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from diner_tpu_torch.data.io import read_rgb

RGBA_FNAME = "rgba_colorcalib_v2.png"
DEPTH_FNAME = "depth_gt_pred_conf.png"
DEPTH_MESH_FNAME = "depth_mesh.png"
DEPTH_PNG_SCALE = 1e-4


def conf2std(conf):
    return -1.582e-2 * conf + 1.649e-2


def to_homogeneous(trafo34: np.ndarray) -> np.ndarray:
    bottom = np.zeros(trafo34.shape[:-2] + (1, 4), trafo34.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([trafo34, bottom], axis=-2)


def read_rgba(path, bg: float = 1.0):
    """→ (rgb (H,W,3), alpha (H,W,1)); background forced to `bg` under
    alpha < 0.5."""
    arr = read_rgb(path)  # (H, W, 4)
    rgb, a = arr[..., :3].copy(), arr[..., 3:4]
    rgb[a[..., 0] < 0.5] = bg
    return rgb, a


def read_depth_triptych(path, mesh_path=None, depth_type: str = "original"):
    """[gt | pred | conf] uint16 triptych → (depth (H,W,1), conf (H,W,1))."""
    from PIL import Image
    trip = np.asarray(Image.open(path)).astype(np.float32) * DEPTH_PNG_SCALE
    W = trip.shape[1] // 3
    pred_mvs = trip[:, W:2 * W]
    conf_mvs = trip[:, 2 * W:3 * W]
    if depth_type == "original":
        d, c = pred_mvs, conf_mvs
    else:
        mesh = np.asarray(Image.open(mesh_path)).astype(np.float32) \
            * DEPTH_PNG_SCALE
        mesh_conf = np.where(mesh == 0.0, 0.0, 0.8).astype(np.float32)
        if depth_type == "mesh":
            d, c = mesh, mesh_conf
        elif depth_type == "merge":
            d = np.where((mesh == 0.0) & (pred_mvs != 0.0), pred_mvs, mesh)
            c = np.where((mesh_conf == 0.0) & (conf_mvs != 0.0), conf_mvs,
                         mesh_conf)
        else:
            raise ValueError(depth_type)
    return d[..., None], c[..., None]


class FacescapeDataset:
    znear = 1.0
    zfar = 2.5

    range_hor = 45  # horizontal camera range (facescape.py:26, 387)

    def __init__(self, root, stage: str, model: str = "DINER",
                 depth_type: str = "original", depth_fname: Optional[str] = None,
                 depth_root: Optional[str] = None,
                 split_dir: str = "assets/data_splits/facescape",
                 n_repeat: Optional[int] = None):
        self.data_dir = Path(root)
        assert os.path.exists(root), root
        self.stage = stage
        self.model = model
        self.depth_type = depth_type
        self.depth_fname = depth_fname or DEPTH_FNAME
        self.depth_root = Path(depth_root) if depth_root else None
        self.rnd = (np.random.default_rng() if stage == "train"
                    else np.random.default_rng(128))
        self.nsource = 2

        meta_fpath = Path(split_dir) / f"{stage}_metas_binocular.txt"
        with open(meta_fpath) as f:
            metas = json.load(f)
        if n_repeat is None:
            n_repeat = 5 if stage == "train" else 20
        self.metas = list(itertools.chain.from_iterable(
            itertools.repeat(m, n_repeat) for m in metas))

    def __len__(self):
        return len(self.metas)

    def get_cam_sweep_extrinsics(self, nframes: int, scan_idx: int,
                                 elevation: float = 0.0,
                                 radius: float = 1.8,
                                 sweep_range: Optional[float] = None
                                 ) -> np.ndarray:
        """Horizontal arc of target cameras around the head
        (facescape.py:365-424): the base camera sits along the mean source
        direction at ``radius``, looks at the origin with world -z as image
        down, and is swept ±sweep_range° about the world z axis."""
        base = self[scan_idx]
        src_extr = np.asarray(base["src_extrinsics"], np.float64)
        centers = -np.einsum("nji,njk->nik", src_extr[:, :3, :3],
                             src_extr[:, :3, 3:])[..., 0]  # (N, 3)
        dirs = centers / np.linalg.norm(centers, axis=-1, keepdims=True)
        mean_dir = dirs.sum(axis=0)
        mean_dir /= np.linalg.norm(mean_dir)
        center = mean_dir * radius
        z_ax = -center / np.linalg.norm(center)
        y_ax = np.array([0.0, 0.0, -1.0])
        x_ax = np.cross(y_ax, z_ax)
        x_ax /= np.linalg.norm(x_ax)

        base_pose = np.eye(4)
        base_pose[:3, 0] = x_ax
        base_pose[:3, 1] = y_ax
        base_pose[:3, 2] = z_ax
        base_pose[:3, 3] = center

        sweep_range = (sweep_range if sweep_range is not None
                       else self.range_hor)
        alphas = np.linspace(-sweep_range, sweep_range,
                             nframes) / 180.0 * np.pi
        rots = np.stack([
            np.array([[np.cos(a), -np.sin(a), 0, 0],
                      [np.sin(a), np.cos(a), 0, 0],
                      [0, 0, 1, 0],
                      [0, 0, 0, 1.0]]) for a in alphas])
        target_poses = rots @ base_pose[None]
        return np.linalg.inv(target_poses).astype(np.float32)

    @staticmethod
    def int_to_viewdir(i: int) -> str:
        return f"view_{i:05d}"

    # -- debug harnesses (reference facescape.py:425-571) ----------------

    def visualize_item(self, idx: int, show: bool = True, outfile=None):
        from diner_tpu_torch.data.debug import visualize_item
        visualize_item(self[idx], show=show, outfile=outfile)

    def visualize_camgrid(self, i: int = 0, show: bool = True,
                          outfile=None):
        from diner_tpu_torch.data.debug import visualize_camgrid
        scan_path = self.data_dir / self.metas[i]["scan_path"]
        with open(scan_path / "cameras.json") as f:
            cam_dict = json.load(f)
        ids = sorted(cam_dict.keys(), key=int)
        extr = to_homogeneous(np.asarray(
            [cam_dict[c]["extrinsics"] for c in ids], np.float64))
        return visualize_camgrid(extr, labels=ids, show=show,
                                 outfile=outfile)

    def reproject_depth(self, sample_idx: int = 0, outfile=None):
        from diner_tpu_torch.data.debug import reproject_depth
        return reproject_depth(self[sample_idx], outfile=outfile)

    def check_depth_existence(self):
        from diner_tpu_torch.data.debug import check_depth_existence
        suffix = "_val" if self.stage == "val" else ""

        def paths(meta):
            mp = Path(meta["scan_path"])
            for key in ("l_refs" + suffix, "r_refs" + suffix):
                for vid in meta[key]:
                    yield self._depth_paths(mp, vid)["trip"]

        check_depth_existence(self.metas, paths)

    def _depth_paths(self, meta_path: Path, view_id) -> Dict[str, Path]:
        """Depth locations; `depth_root` mirrors the fork's flat side-tree
        (path components joined by '_'), otherwise the dataset tree itself."""
        vd = self.int_to_viewdir(int(view_id))
        if self.depth_root is not None:
            flat = "_".join(str(meta_path / vd / self.depth_fname).split("/"))
            flat_mesh = "_".join(str(meta_path / vd / DEPTH_MESH_FNAME).split("/"))
            return {"trip": self.depth_root / "depths_gt_pred_conf" / flat,
                    "mesh": self.depth_root / "depths_mesh" / flat_mesh}
        base = self.data_dir / meta_path / vd
        return {"trip": base / self.depth_fname,
                "mesh": base / DEPTH_MESH_FNAME}

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        suffix = "_val" if self.stage == "val" else ""
        target_id = str(self.rnd.choice(np.array(meta["targets" + suffix])))
        left_id = str(self.rnd.choice(np.array(meta["l_refs" + suffix])))
        right_id = str(self.rnd.choice(np.array(meta["r_refs" + suffix])))
        source_ids = [left_id, right_id]

        scan_path = self.data_dir / meta["scan_path"]
        meta_path = Path(meta["scan_path"])
        frame, subject = scan_path.name, scan_path.parent.name

        target_rgb, target_alpha = read_rgba(
            scan_path / self.int_to_viewdir(int(target_id)) / RGBA_FNAME)

        with open(scan_path / "cameras.json") as f:
            cam_dict = json.load(f)
        t_extr = to_homogeneous(
            np.asarray(cam_dict[target_id]["extrinsics"], np.float32))
        t_intr = np.asarray(cam_dict[target_id]["intrinsics"], np.float32)
        s_extr = to_homogeneous(np.asarray(
            [cam_dict[i]["extrinsics"] for i in source_ids], np.float32))
        s_intr = np.asarray(
            [cam_dict[i]["intrinsics"] for i in source_ids], np.float32)

        sample_name = f"{subject}-{frame}-{target_id}-{'-'.join(source_ids)}-"

        if self.model in ("DINER", "OURS"):
            rgbs, alphas, depths, stds = [], [], [], []
            for sid in source_ids:
                rgb, a = read_rgba(
                    scan_path / self.int_to_viewdir(int(sid)) / RGBA_FNAME)
                paths = self._depth_paths(meta_path, sid)
                d, c = read_depth_triptych(paths["trip"], paths["mesh"],
                                           self.depth_type)
                rgbs.append(rgb)
                alphas.append(a)
                depths.append(d)
                stds.append(c)
            return dict(
                target_rgb=target_rgb,
                target_alpha=target_alpha,
                target_extrinsics=t_extr,
                target_intrinsics=t_intr,
                target_view_id=int(target_id),
                scan_idx=0,
                sample_name=sample_name,
                frame=frame,
                src_rgbs=np.stack(rgbs),
                src_depths=np.stack(depths),
                src_depth_stds=conf2std(np.stack(stds)),
                src_alphas=np.stack(alphas),
                src_extrinsics=s_extr,
                src_intrinsics=s_intr,
                src_view_ids=np.asarray([int(i) for i in source_ids]),
            )

        # KeypointNeRF branch: landmarks + face bounds + ray-box mask
        kpt3d = np.loadtxt(scan_path / "3dlmks.npy", dtype=np.float32)
        rgbs, alphas, masks = [], [], []
        for sid in source_ids:
            rgb, a = read_rgba(
                scan_path / self.int_to_viewdir(int(sid)) / RGBA_FNAME)
            m = rgb.sum(-1) != 3
            rgb = rgb * m[..., None]
            rgbs.append(rgb)
            alphas.append(a)
            masks.append(m)
        t_mask = target_rgb.sum(-1) != 3
        target_rgb = target_rgb * t_mask[..., None]
        bounds = load_face_bounds(scan_path)
        H, W = target_rgb.shape[:2]
        mask_at_box = get_mask_at_box(bounds, t_intr, t_extr[:3, :3],
                                      t_extr[:3, 3], H, W)
        return dict(
            target_rgb=target_rgb,
            target_alpha=target_alpha,
            target_extrinsics=t_extr,
            target_intrinsics=t_intr,
            target_kpt3d=kpt3d,
            target_mask=t_mask,
            target_view_id=int(target_id),
            scan_idx=0,
            bounds=bounds,
            mask_at_box=mask_at_box,
            sample_name=sample_name,
            frame=frame,
            src_rgbs=np.stack(rgbs),
            src_alphas=np.stack(alphas),
            src_extrinsics=s_extr,
            src_intrinsics=s_intr,
            src_mask=np.stack(masks),
            src_view_ids=np.asarray([int(i) for i in source_ids]),
        )


def load_face_bounds(scan_path: Path) -> np.ndarray:
    verts = np.loadtxt(scan_path / "face_vertices.npy", dtype=np.float32)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    lo[2] -= 0.05
    hi[2] += 0.05
    return np.stack([lo, hi])


def get_mask_at_box(bounds, K, R, T, H, W) -> np.ndarray:
    """Per-pixel does-the-ray-hit-the-box mask (facescape.py:127-185)."""
    ray_o = (-R.T @ T).ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pix_cam = xy1 @ np.linalg.inv(K).T
    pix_world = (pix_cam - T.ravel()) @ R
    ray_d = (pix_world - ray_o).reshape(-1, 3)
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5

    b = bounds + np.array([-0.01, 0.01])[:, None]
    d_isect = ((b[None] - ray_o) / ray_d[:, None]).reshape(-1, 6)
    p_isect = d_isect[..., None] * ray_d[:, None] + ray_o
    lo, hi = b[0], b[1]
    eps = 1e-6
    inside = np.all((p_isect >= lo - eps) & (p_isect <= hi + eps), axis=-1)
    return (inside.sum(-1) == 2).reshape(H, W)
