"""Synthetic analytic-sphere scene for deterministic end-to-end runs.

Port-side numpy copy of ``diner_tpu/data/synthetic.py`` (the port imports
nothing of the JAX package): a sphere whose ray depth is known in closed
form, with the batch keys the data layer uses, channels-last.
"""

from __future__ import annotations

import numpy as np


def _look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """world→cam extrinsics for a camera at `eye` looking at `target`."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)  # columns = cam axes
    R = R_c2w.T
    t = -R @ eye
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = t
    return E.astype(np.float32)


def _render_sphere(extr, intr, H, W, radius=0.5, center=(0.0, 0.0, 0.0)):
    """Analytic z-depth, RGB (lambertian from normals), alpha for a sphere."""
    R = extr[:3, :3]
    t = extr[:3, 3]
    R_c2w = R.T
    cam_pos = -R_c2w @ t

    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    xs = (np.arange(0.5, W) - cx) / fx
    ys = (np.arange(0.5, H) - cy) / fy
    gx, gy = np.meshgrid(xs, ys)
    dirs_cam = np.stack([gx, gy, np.ones_like(gx)], axis=-1)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs = dirs_cam @ R_c2w.T  # world

    oc = cam_pos - np.asarray(center)
    b = 2.0 * (dirs @ oc)
    cq = oc @ oc - radius * radius
    disc = b * b - 4 * cq
    hit = disc > 0
    s = (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0
    hit &= s > 0

    pts = cam_pos + s[..., None] * dirs
    # z-depth in the camera frame (the reference's depth-map convention)
    zdepth = (pts @ R.T + t)[..., 2]
    zdepth = np.where(hit, zdepth, 0.0)

    normals = (pts - center) / radius
    light = np.array([0.5, 0.7, 0.5])
    light = light / np.linalg.norm(light)
    lam = np.clip(normals @ light, 0.0, 1.0)
    base = np.clip(normals * 0.5 + 0.5, 0, 1)
    rgb = 0.2 * base + 0.8 * base * lam[..., None]
    rgb = np.where(hit[..., None], rgb, 1.0)  # white background
    return (rgb.astype(np.float32), zdepth.astype(np.float32),
            hit.astype(np.float32))


def make_sphere_scene(H=32, W=32, nv=2, sb=1, depth_std=0.01, seed=0,
                      target_angle=0.35):
    """Build a batch dict for a sphere scene with `nv` source views.

    Returns channels-last numpy arrays (host-side, like the data layer):
      src_rgbs (SB,NV,H,W,3), src_depths / src_depth_stds (SB,NV,H,W,1),
      src_extrinsics (SB,NV,4,4), src_intrinsics (SB,NV,3,3),
      target_rgb (SB,H,W,3), target_alpha (SB,H,W,1),
      target_extrinsics (SB,4,4), target_intrinsics (SB,3,3),
      target_depth (SB,H,W,1), znear (SB,), zfar (SB,)
    """
    focal = 1.2 * max(H, W)
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    np.float32)

    dist = 1.6
    src_angles = np.linspace(0, 2 * np.pi, nv, endpoint=False) + 0.3
    src_extr, src_rgb, src_depth = [], [], []
    for a in src_angles:
        eye = np.array([dist * np.sin(a), 0.3, -dist * np.cos(a)])
        E = _look_at(eye)
        rgb, d, _ = _render_sphere(E, intr, H, W)
        src_extr.append(E)
        src_rgb.append(rgb)
        src_depth.append(d)

    eye_t = np.array([dist * np.sin(target_angle), 0.25,
                      -dist * np.cos(target_angle)])
    Et = _look_at(eye_t)
    t_rgb, t_depth, t_alpha = _render_sphere(Et, intr, H, W)

    src_rgb = np.stack(src_rgb)[None]
    src_depth = np.stack(src_depth)[None, ..., None]
    stds = np.where(src_depth > 0, depth_std, 0.0).astype(np.float32)

    def tile(x, reps):
        return np.tile(x, reps + (1,) * (x.ndim))

    batch = dict(
        src_rgbs=src_rgb,
        src_depths=src_depth,
        src_depth_stds=stds,
        src_extrinsics=np.stack(src_extr)[None],
        src_intrinsics=np.tile(intr, (1, nv, 1, 1)),
        target_rgb=t_rgb[None],
        target_alpha=t_alpha[None, ..., None],
        target_depth=t_depth[None, ..., None],
        target_extrinsics=Et[None],
        target_intrinsics=intr[None],
        znear=np.array([dist - 0.8], np.float32),
        zfar=np.array([dist + 0.8], np.float32),
    )
    if sb > 1:
        batch = {k: np.repeat(v, sb, axis=0) for k, v in batch.items()}
    # host-side numpy, like the real data layer; device placement is the
    # caller's job
    return {k: np.asarray(v) for k, v in batch.items()}
