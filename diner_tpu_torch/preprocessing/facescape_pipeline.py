"""Facescape raw-capture → DINER-format preprocessing pipeline.

Parity targets:
  - ``deps/facescape_preprocessing/process_dataset.py`` — per pose: read
    params.json cameras, align world via Rt_scale_dict (capture-studio
    convention, mm → m), undistort each view, render mesh depth, silhouette-
    crop to a square with side-dependent anchoring, area-resize, write
    ``view_XXXXX/rgba.png`` + ``depth.png`` (uint16 ×1e-4 m) and per-scan
    ``cameras.json`` / ``3dlmks.npy``.
  - ``deps/facescape_preprocessing/calibrate_colors.py`` — per-scan affine
    color calibration with l1 / red-outlier gating and corrected-image
    fallbacks.

Port of ``diner_tpu/preprocessing/facescape_pipeline.py``. GL-free:
depth rendering is kernel R (:mod:`diner_tpu_torch.preprocessing.rasterize`)
at each raw view's own size and at the crop size in the calibration, and
the calibration's vertex colours are sampled through kernel C; both run on
``device`` (default ``cuda``). cv2.undistort is replaced by an explicit
Brown-Conrady forward-distortion remap.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from diner_tpu_torch.data.io import resize_bilinear, resize_nearest
from diner_tpu_torch.preprocessing.facescape import (
    apply_color_calibration,
    collect_vertex_colors,
    color_calibration_affine,
)
from diner_tpu_torch.preprocessing.rasterize import (
    load_obj_vertices_faces,
    rasterize_depth,
)

UINT16_MAX = 65535
SCALE_FACTOR = 1e-4  # meters → uint16 at 0.1 mm resolution
FACESCAPE_2_CAPSTUDIO = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])


def to_homogeneous_trafo(trafo: np.ndarray) -> np.ndarray:
    """(N, 3, 4) → (N, 4, 4) (process_dataset.py:19-25)."""
    bottom = np.tile(np.array([[[0.0, 0, 0, 1]]]), (len(trafo), 1, 1))
    return np.concatenate([trafo, bottom], axis=1)


def inv_extrinsics(extr: np.ndarray) -> np.ndarray:
    """Invert (N, 4, 4) rigid transforms (process_dataset.py:60-74)."""
    R = extr[:, :3, :3]
    T = extr[:, :3, -1:]
    R_inv = R.transpose(0, 2, 1)
    T_inv = -R_inv @ T
    return to_homogeneous_trafo(np.concatenate([R_inv, T_inv], axis=-1))


def read_cam_extrinsics(cam_dict: Dict) -> np.ndarray:
    """params.json "{i}_Rt" entries → (N, 4, 4) (process_dataset.py:27-38)."""
    extrinsics = []
    i = 0
    while f"{i}_Rt" in cam_dict:
        extrinsics.append(cam_dict[f"{i}_Rt"])
        i += 1
    return to_homogeneous_trafo(np.asarray(extrinsics, np.float64))


def get_cam_angles(Rt: np.ndarray,
                   ref_dir=np.array([0.0, 1.0, 0.0])) -> Dict[str, float]:
    """Azimuth/elevation of the camera view direction
    (process_dataset.py:41-58)."""
    cam_viewdir = np.asarray(Rt)[2, :3]
    hor = cam_viewdir.copy()
    hor[2] = 0
    hor = hor / np.sqrt(np.sum(hor ** 2))
    vert = cam_viewdir.copy()
    vert[0] = 0
    vert = vert / np.sqrt(np.sum(vert ** 2))
    azimuth = float(np.arccos(hor @ ref_dir) * 180.0 / np.pi)
    elevation = float(np.arccos(vert @ ref_dir) * 180.0 / np.pi)
    azimuth *= -1 * float(np.sign(hor[0]))
    elevation *= float(np.sign(vert[2]))
    return dict(azimuth=azimuth, elevation=elevation)


def float32_2_uint16(x: np.ndarray) -> np.ndarray:
    float_max = UINT16_MAX * SCALE_FACTOR
    return (x.clip(max=float_max) / SCALE_FACTOR).round().astype(np.uint16)


# ---------------------------------------------------------------------------
# undistortion (cv2.undistort equivalent)
# ---------------------------------------------------------------------------

def undistort_image(img: np.ndarray, K: np.ndarray, dist: np.ndarray
                    ) -> np.ndarray:
    """Brown-Conrady undistortion with the same K for the output canvas.

    For each undistorted output pixel, apply the distortion model to find
    the source pixel and bilinearly sample (what
    ``cv2.undistort(img, K, dist)`` computes via initUndistortRectifyMap).
    dist = (k1, k2, p1, p2[, k3...]).
    """
    H, W = img.shape[:2]
    d = np.zeros(8)
    dist = np.asarray(dist, np.float64).ravel()
    d[: len(dist)] = dist
    k1, k2, p1, p2, k3 = d[0], d[1], d[2], d[3], d[4]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = x_d * fx + cx
    map_y = y_d * fy + cy
    return _remap_bilinear(img, map_x, map_y)


def _remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
                    ) -> np.ndarray:
    H, W = img.shape[:2]
    x0 = np.floor(map_x).astype(int)
    y0 = np.floor(map_y).astype(int)
    wx = (map_x - x0)[..., None]
    wy = (map_y - y0)[..., None]
    valid = ((map_x >= 0) & (map_x <= W - 1)
             & (map_y >= 0) & (map_y <= H - 1))[..., None]
    x0c = np.clip(x0, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    img3 = img if img.ndim == 3 else img[..., None]
    top = img3[y0c, x0c] * (1 - wx) + img3[y0c, x1c] * wx
    bot = img3[y1c, x0c] * (1 - wx) + img3[y1c, x1c] * wx
    out = top * (1 - wy) + bot * wy
    out = np.where(valid, out, 0.0)
    return out if img.ndim == 3 else out[..., 0]


# ---------------------------------------------------------------------------
# silhouette crop (process_dataset.py:178-210)
# ---------------------------------------------------------------------------

def silhouette_crop_bbx(mask: np.ndarray, cam_center_x: float,
                        padding_v: float = 0.01, padding_h: float = 0.05
                        ) -> Tuple[int, int, int, int]:
    """Square crop (top, bottom, left, right) anchored at the silhouette side
    facing the camera."""
    h, w = mask.shape
    crop_in = min(h, w)
    padding_px_v = int(crop_in * padding_v)
    padding_px_h = int(crop_in * padding_h)
    fg_y, fg_x = np.where(mask)
    silh_top = np.min(fg_y)
    silh_left = np.min(fg_x)
    silh_right = np.max(fg_x)

    if cam_center_x < 0:  # cam on right head side → anchor right
        bbx_top = np.clip(silh_top - padding_px_v, 0, None)
        bbx_right = np.clip(silh_right + padding_px_h, None, w)
        bbx_bottom = np.clip(bbx_top + crop_in, None, h)
        bbx_left = np.clip(bbx_right - crop_in, 0, None)
        bbx_top = bbx_bottom - crop_in
        bbx_right = bbx_left + crop_in
    else:  # cam on left head side → anchor left
        bbx_top = np.clip(silh_top - padding_px_v, 0, None)
        bbx_left = np.clip(silh_left - padding_px_h, 0, None)
        bbx_bottom = np.clip(bbx_top + crop_in, None, h)
        bbx_right = np.clip(bbx_left + crop_in, None, w)
        bbx_top = bbx_bottom - crop_in
        bbx_left = bbx_right - crop_in
    return int(bbx_top), int(bbx_bottom), int(bbx_left), int(bbx_right)


def area_resize(img: np.ndarray, out: int) -> np.ndarray:
    """INTER_AREA-style square resize (box average when integer ratio)."""
    H, W = img.shape[:2]
    if H % out == 0 and W % out == 0:
        fh, fw = H // out, W // out
        x3 = img if img.ndim == 3 else img[..., None]
        r = x3.reshape(out, fh, out, fw, -1).mean(axis=(1, 3))
        return r if img.ndim == 3 else r[..., 0]
    return resize_bilinear(img, out, out)


# ---------------------------------------------------------------------------
# per-pose processing
# ---------------------------------------------------------------------------

def process_pose(pose_dir: Path, out_subject_root: Path,
                 align_Rts_dict: Dict, lm_indices: Optional[np.ndarray],
                 crop_out: int = 256, padding_v: float = 0.01,
                 padding_h: float = 0.05, calibrate: bool = True,
                 device=None) -> bool:
    from PIL import Image

    s_idx = pose_dir.parent.name
    p_idx = pose_dir.name.split("_")[0]
    with open(pose_dir / "params.json") as f:
        cam_dict = json.load(f)
    extrinsics = read_cam_extrinsics(cam_dict)
    verts, faces = _load_mesh(pose_dir.parent / (pose_dir.name + ".ply"))

    lmk_3d = None
    if lm_indices is not None:
        reg = pose_dir.parent / "models_reg" / (pose_dir.name + ".obj")
        if reg.exists():
            reg_verts, _ = load_obj_vertices_faces(reg)
            lmk_3d = reg_verts[lm_indices]

    poses = inv_extrinsics(extrinsics)
    scale_align = align_Rts_dict[s_idx][p_idx][0]
    Rt_align = np.asarray(align_Rts_dict[s_idx][p_idx][1], np.float64)
    Rt_align = to_homogeneous_trafo(Rt_align[None])[0]
    Rt_align[:3] = FACESCAPE_2_CAPSTUDIO @ Rt_align[:3]
    poses[:, :3, -1] *= scale_align
    poses = np.tile(Rt_align[None], (len(extrinsics), 1, 1)) @ poses
    poses[:, :3, -1] /= 1000
    extrinsics = inv_extrinsics(poses)
    verts = verts * scale_align
    verts = verts @ Rt_align[:3, :3].T + Rt_align[:3, 3]
    verts = (verts / 1000).astype(np.float32)
    if lmk_3d is not None:
        lmk_3d = (FACESCAPE_2_CAPSTUDIO @ lmk_3d.T).T / 1000

    cam_outdict = {}
    view_files = sorted(p for p in pose_dir.iterdir()
                        if not p.name.endswith(".json"))
    for img_path in view_files:
        i_idx = img_path.name.split(".")[0]
        if f"{i_idx}_K" not in cam_dict or not cam_dict.get(
                f"{i_idx}_valid", False):
            continue
        K = np.asarray(cam_dict[i_idx + "_K"], np.float64)
        Rt = extrinsics[int(i_idx), :3]
        pose = poses[int(i_idx)]
        distortion = np.asarray(cam_dict[i_idx + "_distortion"], np.float64)
        w = cam_dict[i_idx + "_width"]
        h = cam_dict[i_idx + "_height"]

        rgb = np.asarray(Image.open(img_path), np.float64)[..., :3] / 255.0
        rgb = undistort_image(rgb, K, distortion)
        depth = rasterize_depth(
            verts, faces, K.astype(np.float32), Rt.astype(np.float32),
            int(h), int(w), device=device).cpu().numpy()
        mask = depth > 0
        if not mask.any():
            continue

        crop_in = min(h, w)
        t, b, l, r = silhouette_crop_bbx(mask, pose[0, -1],
                                         padding_v, padding_h)
        rgb = rgb[t:b, l:r]
        depth = depth[t:b, l:r]
        K = K.copy()
        K[0, -1] -= l
        K[1, -1] -= t

        rgb = area_resize(rgb, crop_out)
        depth = resize_nearest(depth, crop_out, crop_out)
        mask = depth > 0
        K[:2] *= crop_out / crop_in

        outdir = out_subject_root / f"{int(p_idx):02d}" / \
            f"view_{int(i_idx):05d}"
        outdir.mkdir(parents=True, exist_ok=True)
        rgba = np.concatenate(
            [np.clip(rgb * 255, 0, 255),
             mask[..., None].astype(np.float64) * 255], axis=-1)
        Image.fromarray(rgba.astype(np.uint8)).save(outdir / "rgba.png")
        Image.fromarray(float32_2_uint16(depth)).save(outdir / "depth.png")
        cam_outdict[int(i_idx)] = dict(intrinsics=K.tolist(),
                                       extrinsics=Rt.tolist(),
                                       angles=get_cam_angles(Rt))

    out_scan_dir = out_subject_root / f"{int(p_idx):02d}"
    if not out_scan_dir.exists():
        return False
    if lmk_3d is not None:
        np.savetxt(out_scan_dir / "3dlmks.npy", lmk_3d)
    with open(out_scan_dir / "cameras.json", "w") as f:
        json.dump(cam_outdict, f)
    if calibrate:
        calibrate_colors_scan(out_scan_dir, verts, faces, device=device)
    return True


def _load_mesh(path: Path):
    if path.suffix == ".obj":
        return load_obj_vertices_faces(path)
    return load_ply(path)


def load_ply(path):
    """Minimal PLY reader (ascii / binary_little_endian; x y z + faces)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        n_vert = n_face = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n_vert = int(line.split()[-1])
                in_vertex = True
            elif line.startswith(b"element face"):
                n_face = int(line.split()[-1])
                in_vertex = False
            elif line.startswith(b"property") and in_vertex:
                vert_props.append((line.split()[1].decode(),
                                   line.split()[2].decode()))
            elif line == b"end_header":
                break
        type_map = {"float": "f4", "float32": "f4", "double": "f8",
                    "uchar": "u1", "uint8": "u1", "int": "i4",
                    "uint": "u4", "short": "i2", "ushort": "u2"}
        if fmt == "ascii":
            verts = []
            for _ in range(n_vert):
                vals = f.readline().split()
                verts.append([float(v) for v in vals[:3]])
            faces = []
            for _ in range(n_face):
                vals = [int(v) for v in f.readline().split()]
                idx = vals[1:1 + vals[0]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            return (np.asarray(verts, np.float32),
                    np.asarray(faces, np.int32))
        # binary little endian
        dt = np.dtype([(f"p{i}", "<" + type_map[t])
                       for i, (t, _) in enumerate(vert_props)])
        raw = np.frombuffer(f.read(n_vert * dt.itemsize), dt)
        verts = np.stack([raw["p0"], raw["p1"], raw["p2"]],
                         axis=-1).astype(np.float32)
        faces = []
        for _ in range(n_face):
            cnt = np.frombuffer(f.read(1), np.uint8)[0]
            idx = np.frombuffer(f.read(4 * cnt), "<i4")
            for i in range(1, cnt - 1):
                faces.append([idx[0], idx[i], idx[i + 1]])
        return verts, np.asarray(faces, np.int32)


# ---------------------------------------------------------------------------
# per-scan color calibration (calibrate_colors.py:31-262)
# ---------------------------------------------------------------------------

def calibrate_colors_scan(root: Path, verts: np.ndarray, faces: np.ndarray,
                          rgb_in_fname: str = "rgba.png",
                          rgb_out_fname: str = "rgba_colorcalib.png",
                          specular_thr: float = 0.7,
                          l1_thr: float = 0.085,
                          red_outlier_thr: float = 0.3,
                          red_outlier_ratio_thr: float = 0.03,
                          device=None):
    from PIL import Image

    with open(root / "cameras.json") as f:
        cam_dict = json.load(f)
    cam_ids = sorted(cam_dict.keys(), key=int)

    all_colors, all_idcs, imgs, alphas = [], [], [], []
    used_ids = []
    for camid in cam_ids:
        img_path = root / f"view_{int(camid):05d}" / rgb_in_fname
        if not img_path.exists():
            continue
        rgba = np.asarray(Image.open(img_path), np.float32) / 255.0
        rgb, alpha = rgba[..., :3], rgba[..., 3:]
        h, w = rgb.shape[:2]
        K = np.asarray(cam_dict[camid]["intrinsics"], np.float32)
        Rt = np.asarray(cam_dict[camid]["extrinsics"], np.float32)
        depth = rasterize_depth(verts, faces, K, Rt, h, w,
                                device=device).cpu().numpy()

        vh = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=-1)
        v_cam = vh @ np.vstack([Rt, [0, 0, 0, 1]]).T
        uvz = v_cam[:, :3] @ K.T
        uv = uvz[:, :2] / uvz[:, 2:]
        uv_ndc = uv / np.array([[w, h]]) * 2 - 1
        colors, idcs = collect_vertex_colors(
            rgb, depth, uv_ndc.astype(np.float32),
            uvz[:, 2].astype(np.float32), specular_thr=specular_thr,
            device=device)
        all_colors.append(colors)
        all_idcs.append(idcs)
        imgs.append(rgb)
        alphas.append(alpha)
        used_ids.append(camid)

    if not used_ids:
        return

    n_verts = len(verts)
    mean = np.zeros((n_verts, 3), np.float64)
    count = np.zeros((n_verts,), np.float64)
    for c, idx in zip(all_colors, all_idcs):
        np.add.at(mean, idx, c)
        np.add.at(count, idx, 1)
    mean /= count[:, None] + 1e-4

    l1, red_ratio = [], []
    for c, idx in zip(all_colors, all_idcs):
        e = np.abs(mean[idx] - c)
        l1.append(e.mean() if len(e) else np.inf)
        red_ratio.append(float(np.mean((e[:, 0] > red_outlier_thr)
                                       & np.all(c < 50 / 255, axis=-1)))
                         if len(e) else 1.0)

    correctors = color_calibration_affine(all_colors, all_idcs, n_verts)

    l1_corr = []
    for c, idx, A in zip(all_colors, all_idcs, correctors):
        ch = np.concatenate([c, np.ones_like(c[:, :1])], axis=-1)
        l1_corr.append(np.abs(mean[idx] - ch @ A.T).mean()
                       if len(c) else np.inf)

    for i, camid in enumerate(used_ids):
        out_path = root / f"view_{int(camid):05d}" / rgb_out_fname
        if l1[i] > l1_thr or red_ratio[i] > red_outlier_ratio_thr:
            continue  # cannot be corrected (calibrate_colors.py:221-229)
        if l1[i] < l1_corr[i]:
            rgb = imgs[i]  # correction didn't help → copy unchanged
        else:
            rgb = apply_color_calibration(imgs[i], correctors[i])
        rgba = np.concatenate([np.clip(rgb, 0, 1), alphas[i]], axis=-1)
        Image.fromarray((rgba * 255).astype(np.uint8)).save(out_path)
