"""Facescape preprocessing primitives.

Port of ``diner_tpu/preprocessing/facescape.py``: the numpy functions
unchanged, ``collect_vertex_colors`` sampling through the port's
``ops/grid_sample.py`` (kernel C on the card). Parity targets:
  - ``src/util/torch_helpers.py:241-291`` (masked_downsampling): average-pool
    downsampling that never bleeds background color into the foreground.
  - ``deps/facescape_preprocessing/calibrate_colors.py`` — per-camera affine
    color calibration: project mesh vertices into every view, collect
    visible non-specular vertex colors, compute cross-camera mean colors,
    and fit a per-camera robust affine correction ``A (3, 4)`` minimizing
    |A·[c;1] − mean|. The reference uses sklearn's HuberRegressor; here the
    same Huber objective is solved by IRLS on a ridge-regularized lstsq.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.ops.grid_sample import (
    grid_sample_bilinear,
    grid_sample_nearest,
)


def masked_downsampling(x: np.ndarray, mask: np.ndarray, factor: int,
                        mode: str = "average", bg_color: float = 0.0
                        ) -> np.ndarray:
    """Downsample (H, W, C) by an integer factor without fg/bg bleeding.

    mask: (H, W, 1) foreground weights in [0, 1].
    """
    H, W, C = x.shape
    assert H % factor == 0 and W % factor == 0
    f = factor

    if mode == "nearest":
        rows = (np.arange(H // f) * f + f // 2).clip(0, H - 1)
        cols = (np.arange(W // f) * f + f // 2).clip(0, W - 1)
        return x[rows][:, cols]
    if mode != "average":
        raise ValueError(mode)

    xm = np.where(mask < 1.0, 0.0, x)
    x_sum = xm.reshape(H // f, f, W // f, f, C).sum(axis=(1, 3))
    m_sum = mask.reshape(H // f, f, W // f, f, 1).sum(axis=(1, 3))
    m_nearest = masked_downsampling(mask, mask, f, mode="nearest")
    fg = m_nearest[..., 0] > 0
    out = np.full_like(x_sum, bg_color)
    out[fg] = x_sum[fg] / m_sum[fg]
    return out


def _huber_irls(X: np.ndarray, y: np.ndarray, delta: float = 1.0,
                ridge: float = 1e-6, iters: int = 20) -> np.ndarray:
    """Huber-loss linear regression via iteratively reweighted lstsq."""
    w = np.ones(len(y))
    beta = np.zeros(X.shape[1])
    for _ in range(iters):
        Xw = X * w[:, None]
        A = Xw.T @ X + ridge * np.eye(X.shape[1])
        b = Xw.T @ y
        beta_new = np.linalg.solve(A, b)
        r = y - X @ beta_new
        absr = np.abs(r)
        w = np.where(absr <= delta, 1.0, delta / np.maximum(absr, 1e-12))
        if np.allclose(beta_new, beta, atol=1e-9):
            beta = beta_new
            break
        beta = beta_new
    return beta


def color_calibration_affine(
    vert_colors: Sequence[np.ndarray],
    vert_idcs: Sequence[np.ndarray],
    n_verts: int,
    huber_delta: float = 1.0,
) -> List[np.ndarray]:
    """Fit per-camera affine color correctors.

    Args:
      vert_colors: per camera, (Ni, 3) observed colors of visible vertices.
      vert_idcs: per camera, (Ni,) vertex indices.
      n_verts: total vertex count.

    Returns:
      list of (3, 4) correction matrices A with c' = A @ [c; 1].
    """
    mean = np.zeros((n_verts, 3), np.float64)
    count = np.zeros((n_verts,), np.float64)
    for c, idx in zip(vert_colors, vert_idcs):
        np.add.at(mean, idx, c)
        np.add.at(count, idx, 1)
    mean /= (count[:, None] + 1e-4)

    out = []
    for c, idx in zip(vert_colors, vert_idcs):
        X = np.concatenate([c, np.ones_like(c[:, :1])], axis=-1)
        y = mean[idx] - c  # solve for the residual transform (A - I)
        A = []
        for ch in range(3):
            beta = _huber_irls(X, y[:, ch], delta=huber_delta)
            beta[ch] += 1.0
            A.append(beta)
        out.append(np.stack(A).astype(np.float32))
    return out


def apply_color_calibration(img: np.ndarray, A: np.ndarray) -> np.ndarray:
    """Apply a (3, 4) affine corrector to an (H, W, 3) image in [0, 1]."""
    h = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    return np.clip(h @ A.T, 0.0, 1.0)


def collect_vertex_colors(img, depth, verts_cam_uv_ndc, verts_cam_z,
                          depth_thresh: float = 0.003,
                          specular_thr: float = 0.7, device=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Visible, non-specular vertex colors for one view
    (calibrate_colors.py:80-110).

    img: (H, W, 3); depth: (H, W); verts_cam_uv_ndc: (N, 2) in [-1, 1];
    verts_cam_z: (N,). Returns (colors (M, 3), indices (M,)). The samples
    run on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    uv = torch.as_tensor(np.asarray(verts_cam_uv_ndc, np.float32),
                         device=dev)[None]
    d = grid_sample_nearest(
        torch.as_tensor(np.asarray(depth, np.float32),
                        device=dev)[None, ..., None], uv, "zeros")
    c = grid_sample_bilinear(
        torch.as_tensor(np.asarray(img, np.float32), device=dev)[None], uv,
        "border")
    d = d[0, :, 0].cpu().numpy()
    c = c[0].cpu().numpy()
    visible = (d != 0) & (np.abs(d - verts_cam_z) < depth_thresh)
    non_specular = c.mean(-1) < specular_thr
    mask = visible & non_specular
    return c[mask], np.where(mask)[0]
