"""Dataset debug harnesses (the reference's de-facto tests).

Parity targets: ``visualize_item`` / ``visualize_camgrid``
(``src/data/dtu.py:342-419``, ``facescape.py:425-515``,
``multiface.py:433+``), ``reproject_depth`` (``facescape.py:516-552``) and
``check_depth_existence`` (``dtu.py:421-439``, ``facescape.py:554-571``).
All host-side numpy/matplotlib; shared across the dataset classes instead
of the reference's per-file copies. Port of ``diner_tpu/data/debug.py``,
unchanged; matplotlib is imported inside the plotting functions only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def camera_centers(extrinsics: np.ndarray) -> np.ndarray:
    """(N, 4, 4) or (N, 3, 4) world→cam → camera centers (N, 3)."""
    E = np.asarray(extrinsics, np.float64)
    return -np.einsum("nji,njk->nik", E[:, :3, :3], E[:, :3, 3:])[..., 0]


def visualize_camgrid(extrinsics: np.ndarray,
                      labels: Optional[Sequence] = None,
                      highlight: Optional[Sequence[int]] = None,
                      scale: float = 0.3, show: bool = True,
                      outfile=None):
    """3-D quiver plot of camera frames (dtu.py:393-419)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    E = np.asarray(extrinsics, np.float64)
    centers = camera_centers(E)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for i, color in enumerate(["red", "green", "blue"]):
        ax.quiver(centers[:, 0], centers[:, 1], centers[:, 2],
                  scale * E[:, i, 0], scale * E[:, i, 1],
                  scale * E[:, i, 2], edgecolor=color)
    if labels is not None:
        for c, lbl in zip(centers, labels):
            ax.text(c[0], c[1], c[2], str(lbl))
    if highlight:
        ax.scatter(centers[highlight, 0], centers[highlight, 1],
                   centers[highlight, 2], s=60, c="black")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    if outfile:
        fig.savefig(outfile)
    if show:
        plt.show()
    plt.close(fig)
    return centers


def visualize_item(sample: dict, show: bool = True, outfile=None):
    """Per-sample contact sheet: target, sources, depths, stds + cam plot
    (dtu.py:342-391, facescape.py:425-480)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    src_rgbs = np.asarray(sample["src_rgbs"])
    src_depths = np.asarray(sample.get("src_depths"))
    src_stds = np.asarray(sample.get("src_depth_stds"))
    nv = len(src_rgbs)
    ncols = max(nv, 2)
    fig, axes = plt.subplots(nrows=4, ncols=ncols,
                             figsize=(3 * ncols, 10))
    axes = np.atleast_2d(axes)
    axes[0, 0].imshow(np.asarray(sample["target_rgb"]))
    axes[0, 0].set_title(str(sample.get("sample_name", "target")),
                         fontsize=7)
    for v in range(nv):
        axes[1, v].imshow(src_rgbs[v])
        if src_depths is not None and src_depths.ndim >= 3:
            d = src_depths[v][..., 0] if src_depths[v].ndim == 3 \
                else src_depths[v]
            axes[2, v].imshow(d, cmap="turbo")
        if src_stds is not None and src_stds.ndim >= 3:
            s = src_stds[v][..., 0] if src_stds[v].ndim == 3 \
                else src_stds[v]
            axes[3, v].imshow(s, cmap="turbo")
    for a in axes.ravel():
        a.axis("off")
    if outfile:
        fig.savefig(outfile)
    if show:
        plt.show()
    plt.close(fig)


def reproject_depth(sample: dict, outfile=None, max_points: int = 100000,
                    seed: int = 0) -> np.ndarray:
    """Unproject every source depth map to a colored world point cloud
    (facescape.py:516-552). Returns (N, 6) [xyz, rgb·255]; optionally
    writes the reference's ';'-separated txt."""
    rng = np.random.RandomState(seed)
    pts_all = []
    src_rgbs = np.asarray(sample["src_rgbs"])
    src_depths = np.asarray(sample["src_depths"])
    Ks = np.asarray(sample["src_intrinsics"], np.float64)
    Es = np.asarray(sample["src_extrinsics"], np.float64)
    for rgb, depth, K, E in zip(src_rgbs, src_depths, Ks, Es):
        d = depth[..., 0] if depth.ndim == 3 else depth
        H, W = d.shape
        xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        rays = np.linalg.inv(K) @ np.stack(
            [xs.ravel(), ys.ravel(), np.ones(H * W)])
        pts_cam = rays * d.ravel()
        E4 = np.vstack([E, [0, 0, 0, 1]]) if E.shape[0] == 3 else E
        pts_w = (np.linalg.inv(E4)
                 @ np.vstack([pts_cam, np.ones(H * W)]))[:3].T
        colors = rgb.reshape(-1, 3)
        valid = d.ravel() > 0
        pts_all.append(np.concatenate(
            [pts_w[valid], np.round(colors[valid] * 255)], axis=-1))
    pts = np.concatenate(pts_all) if pts_all else np.zeros((0, 6))
    if len(pts) > max_points:
        pts = pts[rng.permutation(len(pts))[:max_points]]
    if outfile:
        np.savetxt(outfile, pts, delimiter=";")
    return pts.astype(np.float32)


def check_depth_existence(metas, depth_paths_fn) -> None:
    """Walk all metas; raise FileNotFoundError listing every missing depth
    file (dtu.py:421-439, facescape.py:554-571)."""
    missing = []
    seen = set()
    for meta in metas:
        for p in depth_paths_fn(meta):
            p = Path(p)
            if p in seen:
                continue
            seen.add(p)
            if not p.exists():
                missing.append(str(p))
    if missing:
        raise FileNotFoundError(
            f"{len(missing)} depth files missing:\n" + "\n".join(missing))
