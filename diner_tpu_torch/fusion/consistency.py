"""Reprojection-consistency depth filtering + fusion (the MVS "normal"
and "dynamic" fusion backends).

Port-side copy of ``diner_tpu/fusion/consistency.py`` (reference
``deps/TransMVSNet/test.py:222-386`` and ``dynamic_fusion.py``): reference
depths are projected into each source view, the source depth is sampled
there and reprojected back, and a pixel is kept where the round trip
errs < 1 px and < 1 % in depth (dynamic: level-dependent thresholds);
pixels that pass the photometric confidence and enough views are fused
into a point cloud. numpy, on the host, like the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _bilinear_sample(img: np.ndarray, x: np.ndarray, y: np.ndarray
                     ) -> np.ndarray:
    """cv2.remap(INTER_LINEAR)-style sampling with zero border."""
    H, W = img.shape
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    wx = x - x0
    wy = y - y0
    out = np.zeros_like(x, dtype=np.float32)
    for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                      (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        xi = x0 + dx
        yi = y0 + dy
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = np.zeros_like(out)
        v[valid] = img[yi[valid], xi[valid]]
        out += w * v
    return out


def reproject_with_depth(depth_ref, K_ref, E_ref, depth_src, K_src, E_src):
    """Round-trip reprojection (test.py:222-259)."""
    H, W = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(W), np.arange(H))
    x_ref = x_ref.reshape(-1)
    y_ref = y_ref.reshape(-1)
    ones = np.ones_like(x_ref, dtype=np.float64)

    xyz_ref = np.linalg.inv(K_ref) @ (
        np.vstack([x_ref, y_ref, ones]) * depth_ref.reshape(-1))
    xyz_src = (E_src @ np.linalg.inv(E_ref)) @ np.vstack([xyz_ref, ones])
    xyz_src = xyz_src[:3]
    k_xyz = K_src @ xyz_src
    xy_src = k_xyz[:2] / k_xyz[2:3]

    x_src = xy_src[0].reshape(H, W).astype(np.float32)
    y_src = xy_src[1].reshape(H, W).astype(np.float32)
    sampled = _bilinear_sample(depth_src, x_src, y_src)

    xyz_src2 = np.linalg.inv(K_src) @ (
        np.vstack([xy_src, ones]) * sampled.reshape(-1))
    xyz_rep = (E_ref @ np.linalg.inv(E_src)) @ np.vstack([xyz_src2, ones])
    xyz_rep = xyz_rep[:3]
    depth_rep = xyz_rep[2].reshape(H, W).astype(np.float32)
    k_rep = K_ref @ xyz_rep
    xy_rep = k_rep[:2] / np.where(k_rep[2:3] == 0, 1e-9, k_rep[2:3])
    x_rep = xy_rep[0].reshape(H, W).astype(np.float32)
    y_rep = xy_rep[1].reshape(H, W).astype(np.float32)
    return depth_rep, x_rep, y_rep, x_src, y_src


def check_geometric_consistency(depth_ref, K_ref, E_ref, depth_src, K_src,
                                E_src, pix_thresh: float = 1.0,
                                rel_depth_thresh: float = 0.01):
    """(mask, reprojected depth zeroed outside mask) — test.py:262-279."""
    H, W = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(W), np.arange(H))
    depth_rep, x_rep, y_rep, _, _ = reproject_with_depth(
        depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    dist = np.sqrt((x_rep - x_ref) ** 2 + (y_rep - y_ref) ** 2)
    rel = np.abs(depth_rep - depth_ref) / np.where(depth_ref == 0, 1e-9,
                                                   depth_ref)
    mask = (dist < pix_thresh) & (rel < rel_depth_thresh)
    depth_rep = np.where(mask, depth_rep, 0.0)
    return mask, depth_rep


def filter_and_fuse(depths: Sequence[np.ndarray],
                    confidences: Sequence[np.ndarray],
                    Ks: Sequence[np.ndarray], Es: Sequence[np.ndarray],
                    pairs: Sequence[Tuple[int, List[int]]],
                    images: Sequence[np.ndarray] = None,
                    conf_thresh: float = 0.9, thres_view: int = 3):
    """Photometric + geometric filtering and fusion (test.py:281-386).

    pairs: per reference view, (ref_idx, [src_idx, ...]).
    Returns (points (N, 3), colors (N, 3) or None, masks per ref view).
    """
    all_pts = []
    all_colors = []
    masks = []
    for ref, srcs in pairs:
        depth_ref = depths[ref]
        H, W = depth_ref.shape
        photo_mask = confidences[ref] > conf_thresh
        geo_sum = np.zeros((H, W), np.int32)
        depth_sum = depth_ref.copy()
        for s in srcs:
            m, d_rep = check_geometric_consistency(
                depth_ref, Ks[ref], Es[ref], depths[s], Ks[s], Es[s])
            geo_sum += m.astype(np.int32)
            depth_sum += d_rep
        depth_avg = depth_sum / (geo_sum + 1)
        final = photo_mask & (geo_sum >= thres_view) & (depth_ref > 0)
        masks.append(final)

        ys, xs = np.where(final)
        d = depth_avg[final]
        xyz_cam = np.linalg.inv(Ks[ref]) @ (
            np.vstack([xs, ys, np.ones_like(xs)]) * d)
        E_inv = np.linalg.inv(np.vstack([Es[ref], [0, 0, 0, 1]])
                              if Es[ref].shape[0] == 3 else Es[ref])
        xyz_w = (E_inv @ np.vstack([xyz_cam, np.ones_like(d)]))[:3].T
        all_pts.append(xyz_w.astype(np.float32))
        if images is not None:
            all_colors.append(images[ref][ys, xs])

    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    colors = (np.concatenate(all_colors) if images is not None and all_colors
              else None)
    return pts, colors, masks


def check_geometric_consistency_dynamic(depth_ref, K_ref, E_ref, depth_src,
                                        K_src, E_src, levels=range(2, 11)):
    """Dynamic-threshold consistency (dynamic_fusion.py:117-141): per level
    i, dist < i/4 px and relative depth error < i/1300. Returns (masks per
    level, loosest mask, reprojected depth zeroed outside the loosest
    mask)."""
    H, W = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(W), np.arange(H))
    depth_rep, x_rep, y_rep, _, _ = reproject_with_depth(
        depth_ref, K_ref, E_ref, depth_src, K_src, E_src)
    dist = np.sqrt((x_rep - x_ref) ** 2 + (y_rep - y_ref) ** 2)
    rel = np.abs(depth_rep - depth_ref) / np.where(depth_ref == 0, 1e-9,
                                                   depth_ref)
    masks = [(dist < i / 4) & (rel < i / 1300) for i in levels]
    depth_rep = np.where(masks[-1], depth_rep, 0.0)
    return masks, masks[-1], depth_rep


def filter_and_fuse_dynamic(depths, confidences, Ks, Es, pairs, images=None,
                            photo_threshold: float = 0.3,
                            thres_view: int = 3):
    """Dynamic-consistency filtering + fusion (dynamic_fusion.py:142-280):
    a pixel passes if the loosest-threshold agreement count ≥ thres_view OR
    at any level i it agrees with ≥ i views at that level's (tighter-for-
    smaller-i) thresholds."""
    all_pts, all_colors, out_masks = [], [], []
    for ref, srcs in pairs:
        depth_ref = depths[ref]
        H, W = depth_ref.shape
        photo_mask = confidences[ref] > photo_threshold
        n = len(srcs) + 1
        level_sums = None
        geo_sum = np.zeros((H, W), np.int32)
        depth_sum = depth_ref.copy()
        for s in srcs:
            masks, loose, d_rep = check_geometric_consistency_dynamic(
                depth_ref, Ks[ref], Es[ref], depths[s], Ks[s], Es[s])
            if level_sums is None:
                level_sums = [m.astype(np.int32) for m in masks[: n - 1]]
            else:
                for i, m in enumerate(masks[: n - 1]):
                    level_sums[i] += m.astype(np.int32)
            geo_sum += loose.astype(np.int32)
            depth_sum += d_rep
        geo_mask = geo_sum >= thres_view
        for i, s_lvl in enumerate(level_sums or []):
            geo_mask = geo_mask | (s_lvl >= (i + 2))
        depth_avg = depth_sum / (geo_sum + 1)
        final = photo_mask & geo_mask & (depth_ref > 0)
        out_masks.append(final)

        ys, xs = np.where(final)
        d = depth_avg[final]
        xyz_cam = np.linalg.inv(Ks[ref]) @ (
            np.vstack([xs, ys, np.ones_like(xs)]) * d)
        E_inv = np.linalg.inv(Es[ref])
        xyz_w = (E_inv @ np.vstack([xyz_cam, np.ones_like(d)]))[:3].T
        all_pts.append(xyz_w.astype(np.float32))
        if images is not None:
            all_colors.append(images[ref][ys, xs])

    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    colors = (np.concatenate(all_colors)
              if images is not None and all_colors else None)
    return pts, colors, out_masks
