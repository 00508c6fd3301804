"""Camera-path interpolation utilities (host-side numpy).

Port of ``diner_tpu/geometry/cam_paths.py``, unchanged. Parity target: reference ``src/util/cam_geometry.py:82-236`` — spherical
rendering poses (pose_spherical), least-squares closest points between rays
(get_ray_intersections), rotation+translation Slerp for camera sweeps.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp as RotSlerp


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_phi(phi: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rot_theta(th: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF-style spherical camera pose (cam_geometry.py:112-126)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ c2w


def get_ray_intersections(ray1, ray2):
    """Closest points between two rays [ox oy oz dx dy dz]
    (cam_geometry.py:129-146)."""
    ray1 = np.asarray(ray1, np.float64)
    ray2 = np.asarray(ray2, np.float64)
    A = np.stack([ray1[3:], -ray2[3:]], axis=-1)
    b = (ray2[:3] - ray1[:3])[:, None]
    t = np.linalg.lstsq(A, b, rcond=None)[0].ravel()
    return ray1[:3] + ray1[3:] * t[0], ray2[:3] + ray2[3:] * t[1]


class TransSlerp:
    """Piecewise-linear translation interpolation with clamped
    extrapolation (cam_geometry.py:182-236)."""

    def __init__(self, times, locations):
        idcs = np.argsort(times)
        self._times = np.asarray(times)[idcs]
        self._locations = np.asarray(locations)[idcs]

    def __call__(self, t_q):
        t_q = np.asarray(t_q, np.float64)
        q = np.clip(t_q, self._times.min(), self._times.max())
        earlier = q[:, None] >= self._times[None]
        later = q[:, None] <= self._times[None]
        helper = np.arange(len(self._times))[None].repeat(len(q), 0)
        e_idx = np.where(earlier, helper, 0).max(axis=1)
        l_idx = np.where(later, helper, len(self._times)).min(axis=1)
        t_e = self._times[e_idx]
        t_l = self._times[l_idx]
        dt = np.clip(t_l - t_e, 1e-4, None)
        w_e = np.clip((t_l - q) / dt, 0.0, 1.0)
        return (self._locations[e_idx] * w_e[:, None]
                + self._locations[l_idx] * (1 - w_e)[:, None])


class Slerp:
    """Rotation Slerp + translation interpolation for camera sweeps
    (cam_geometry.py:157-179)."""

    def __init__(self, times, rotations: Rotation, locations):
        self._rot = RotSlerp(times, rotations)
        self._loc = TransSlerp(times, locations)

    def __call__(self, times):
        return self._rot(times), self._loc(times)


def interpolate_poses(poses: np.ndarray, nframes: int) -> np.ndarray:
    """Smooth sweep of (N, 4, 4) cam2world poses → (nframes, 4, 4)."""
    times = np.linspace(0, 1, len(poses))
    slerp = Slerp(times, Rotation.from_matrix(poses[:, :3, :3]),
                  poses[:, :3, 3])
    q = np.linspace(0, 1, nframes)
    rots, locs = slerp(q)
    out = np.tile(np.eye(4, dtype=np.float32), (nframes, 1, 1))
    out[:, :3, :3] = rots.as_matrix()
    out[:, :3, 3] = locs
    return out
