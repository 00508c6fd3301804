"""Port parity: diner_tpu_torch.geometry against diner_tpu.geometry.

Inputs are made with numpy from a seed and fed to both packages; the
sphere scene's depth maps (with their invalid background) drive the normal
cleanup. Tolerances: 1e-5 for elementwise math in f32; projected pixel
coordinates are compared relative to their magnitude (tens of pixels).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from diner_tpu.data.synthetic import make_sphere_scene as jax_scene
from diner_tpu.geometry import normals as jnormals
from diner_tpu.geometry import rays as jrays
from diner_tpu.geometry import transforms as jtf
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.geometry import normals, rays, transforms


def _t(x):
    return torch.from_numpy(np.array(x))


def _poses(rng, SB, NV):
    scene = make_sphere_scene(H=8, W=8, nv=NV, sb=SB)
    poses = scene["src_extrinsics"].copy()
    poses[..., :3, 3] += rng.normal(0, 0.1, (SB, NV, 3)).astype(np.float32)
    return poses


def test_synthetic_scene_is_the_jax_one():
    a = make_sphere_scene(H=16, W=20, nv=3)
    b = jax_scene(H=16, W=20, nv=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_world_to_cam_and_rotate():
    rng = np.random.default_rng(0)
    poses = _poses(rng, 2, 3)
    xyz = rng.normal(0, 1, (2, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        transforms.world_to_cam(_t(xyz), _t(poses)).numpy(),
        np.asarray(jtf.world_to_cam(jnp.asarray(xyz), jnp.asarray(poses))),
        atol=1e-5)
    np.testing.assert_allclose(
        transforms.rotate_to_cam(_t(xyz), _t(poses)).numpy(),
        np.asarray(jtf.rotate_to_cam(jnp.asarray(xyz), jnp.asarray(poses))),
        atol=1e-5)


def test_project_points_and_ndc():
    rng = np.random.default_rng(1)
    xyz_cam = rng.normal(0, 0.3, (2, 3, 40, 3)).astype(np.float32)
    xyz_cam[..., 2] = rng.uniform(0.5, 2.0, (2, 3, 40))
    focal = rng.uniform(30, 60, (2, 3, 2)).astype(np.float32)
    c = rng.uniform(10, 20, (2, 3, 2)).astype(np.float32)
    wh = np.array([40.0, 32.0], np.float32)
    uv = transforms.project_points(_t(xyz_cam), _t(focal), _t(c))
    uv_j = jtf.project_points(jnp.asarray(xyz_cam), jnp.asarray(focal),
                              jnp.asarray(c))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_j), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(
        transforms.uv_to_ndc(uv, _t(wh)).numpy(),
        np.asarray(jtf.uv_to_ndc(uv_j, jnp.asarray(wh))), atol=1e-5)


@pytest.mark.parametrize("H,W", [(32, 40), (7, 5)])
def test_gen_rays(H, W):
    scene = make_sphere_scene(H=H, W=W, nv=2, sb=2)
    extr = scene["src_extrinsics"][:, 0]
    intr = scene["src_intrinsics"][:, 0]
    near = np.array([0.8, 0.9], np.float32)
    far = np.array([2.4, 2.2], np.float32)
    out = rays.gen_rays(_t(extr), _t(intr), W, H, _t(near), _t(far))
    ref = jrays.gen_rays(jnp.asarray(extr), jnp.asarray(intr), W, H,
                         jnp.asarray(near), jnp.asarray(far))
    assert out.shape == (2, H, W, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_depth_to_normal_with_invalid_neighbours():
    scene = make_sphere_scene(H=32, W=40, nv=2)
    d = scene["src_depths"][0, ..., 0]  # (2, H, W), zero off the sphere
    # punch isolated holes so the offset cleanup sees both signs per axis
    d = d.copy()
    d[:, 16, 20] = 0.0
    d[:, 10, 12:14] = 0.0
    intr = scene["src_intrinsics"][0]
    out = normals.depth_to_normal(_t(d), _t(intr)).numpy()
    ref = np.asarray(jnormals.depth_to_normal(jnp.asarray(d),
                                              jnp.asarray(intr)))
    assert (out[d == 0] == 0).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)
