"""Port parity: grid sampling, compositing and the depth-guided sampler.

Each port function and its JAX counterpart get the same numpy inputs (and,
for the sampler, the same uniforms and normals). Tolerances: 1e-5 absolute
for f32 elementwise math and gathers; the sampler's discrete choices (the
top-k shortlist, the ``<`` masks and the nearest-texel rounding) must agree
exactly on the sphere scene, so its z values are compared at 1e-5 too.
The composite is held against both ``composite`` and the Pallas kernel in
interpret mode, on the cases of ``tests/test_pallas_composite.py``; so is
its gradient (the plain ``composite_bwd`` and the autograd Function that
runs it on the CPU), at 1e-5 absolute plus 1e-5 of the largest gradient:
the suffix sums run in another order than autodiff's. The image-only
backward of the bilinear lookup is held against the JAX custom VJP at
1e-5 (f32: the same f32 scatter-adds) and one bf16 ulp (bf16: the f32 sum
is rounded once, where the two sums may fall on either side of a rounding
boundary).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from diner_tpu.geometry.normals import depth_to_normal as j_depth_to_normal
from diner_tpu.geometry.rays import gen_rays as j_gen_rays
from diner_tpu.ops import composite as jcomp
from diner_tpu.ops import grid_sample as jgs
from diner_tpu.ops import sampling as jsamp
from diner_tpu.ops.pallas.composite_pallas import composite_pallas
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.ops import composite as tcomp
from diner_tpu_torch.ops import composite_cuda
from diner_tpu_torch.ops import grid_sample as tgs
from diner_tpu_torch.ops import sampling as tsamp


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _img_uv(seed=0, N=2, H=9, W=11, C=4, P=300, spread=1.3):
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 1, (N, H, W, C)).astype(np.float32)
    uv = rng.uniform(-spread, spread, (N, P, 2)).astype(np.float32)
    return img, uv


# ---------------------------------------------------------------- grid_sample

@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_nearest(mode):
    img, uv = _img_uv(0)
    _close(tgs.grid_sample_nearest(_t(img), _t(uv), mode),
           jgs.grid_sample_nearest(jnp.asarray(img), jnp.asarray(uv), mode))


@pytest.mark.parametrize("mode,align", [("border", False), ("zeros", False),
                                        ("border", True), ("zeros", True)])
def test_grid_sample_bilinear(mode, align):
    img, uv = _img_uv(1)
    out = tgs.grid_sample_bilinear(_t(img), _t(uv), mode, align)
    _close(out, jgs.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(uv),
                                         mode, align))
    _close(out, jgs.grid_sample_bilinear_imggrad(
        jnp.asarray(img), jnp.asarray(uv), mode, align))


def test_bilinear_corners_match():
    img, uv = _img_uv(2)
    for mode in ("border", "zeros"):
        ours = tgs._bilinear_corners(img.shape, _t(uv), mode)
        ref = jgs._bilinear_corners(img.shape, jnp.asarray(uv), mode)
        for (ix, iy, w), (jx, jy, jw) in zip(ours, ref):
            np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
            _close(w, jw)


def test_grid_sample_exponential_nearest():
    # spread 3.5 puts queries beyond the 12-px pad ring of a 9×11 image
    img, uv = _img_uv(3, C=1, spread=3.5)
    img = np.abs(img)
    _close(tgs.grid_sample_exponential_nearest(_t(img), _t(uv), 12, 3.0),
           jgs.grid_sample_exponential_nearest(jnp.asarray(img),
                                               jnp.asarray(uv), 12, 3.0))


def test_exponential_pad_mult():
    rng = np.random.default_rng(4)
    ix = rng.integers(-40, 50, (3, 200))
    iy = rng.integers(-40, 50, (3, 200))
    _close(tgs.exponential_pad_mult(_t(ix), _t(iy), 9, 11, 20, 12.0,
                                    torch.float32),
           jgs.exponential_pad_mult(jnp.asarray(ix, jnp.int32),
                                    jnp.asarray(iy, jnp.int32), 9, 11, 20,
                                    12.0, jnp.float32))


# ------------------------------------------------------------------ composite

def _comp_case(seed=0, SB=2, B=37, K=12):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(SB, B, K).astype(np.float32) * 1.5 + 0.5, axis=-1)
    rgb = rng.rand(SB, B, K, 3).astype(np.float32)
    sigma = (rng.randn(SB, B, K) * 2).astype(np.float32)
    rays = np.zeros((SB, B, 8), np.float32)
    rays[..., 7] = 2.5
    return rgb, sigma, z, rays


@pytest.mark.parametrize("seed,SB,B,K,white", [
    (0, 2, 37, 12, False), (0, 2, 37, 12, True), (2, 1, 130, 5, True),
    (2, 1, 130, 5, False)])
def test_composite_matches_jax_and_pallas(seed, SB, B, K, white):
    rgb, sigma, z, rays = _comp_case(seed, SB, B, K)
    out = tcomp.composite(_t(rgb), _t(sigma), _t(z), _t(rays), white)
    j = [jnp.asarray(a) for a in (rgb, sigma, z, rays)]
    for ref in (jcomp.composite(*j, white_bkgd=white),
                composite_pallas(*j, white_bkgd=white, interpret=True)):
        _close(out.rgb, ref.rgb)
        _close(out.depth, ref.depth)
        _close(out.weights, ref.weights)


def test_composite_wrapper_runs_plain_version_on_cpu():
    rgb, sigma, z, rays = _comp_case(5, 1, 20, 7)
    packed = np.concatenate([rgb, sigma[..., None]], -1)  # field layout
    out_field = _t(packed)
    before = composite_cuda.launches
    out = composite_cuda.composite(out_field[..., :3], out_field[..., 3],
                                   _t(z), _t(rays), True)
    ref = tcomp.composite(_t(rgb), _t(sigma), _t(z), _t(rays), True)
    assert composite_cuda.launches == before
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _jax_composite_grads(fn, rgb, sigma, z, rays, white):
    """(d_rgb, d_sigma) of the loss of ``tests/test_pallas_composite.py``
    through the JAX composite ``fn``."""
    def loss(rgb_, sigma_):
        o = fn(rgb_, sigma_, jnp.asarray(z), jnp.asarray(rays), white)
        return (jnp.sum(o.rgb * jnp.cos(o.rgb)) + jnp.sum(o.depth * 0.7)
                + jnp.sum(o.weights ** 2))
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(rgb),
                                          jnp.asarray(sigma))


def _grad_close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b,
                               atol=1e-5 + 1e-5 * np.abs(b).max(), rtol=0)


_JAX_COMPOSITES = {
    "xla": lambda *a: jcomp.composite(*a[:4], white_bkgd=a[4]),
    "pallas": lambda *a: composite_pallas(*a[:4], white_bkgd=a[4],
                                          interpret=True),
}


@pytest.mark.parametrize("ref", sorted(_JAX_COMPOSITES))
@pytest.mark.parametrize("seed,SB,B,K,white", [
    (1, 1, 19, 9, False), (1, 1, 19, 9, True), (2, 1, 130, 5, True),
    (3, 2, 37, 12, False)])
def test_composite_bwd_matches_jax_grad(ref, seed, SB, B, K, white):
    rgb, sigma, z, rays = _comp_case(seed, SB, B, K)
    j_rgb, j_sigma = _jax_composite_grads(_JAX_COMPOSITES[ref], rgb, sigma,
                                          z, rays, white)
    # the plain VJP, fed the loss's cotangents
    fwd = tcomp.composite(_t(rgb), _t(sigma), _t(z), _t(rays), white)
    g_rgb = torch.cos(fwd.rgb) - fwd.rgb * torch.sin(fwd.rgb)
    g_depth = torch.full_like(fwd.depth, 0.7)
    d_rgb, d_sigma = tcomp.composite_bwd(
        _t(rgb), _t(sigma), _t(z), _t(rays)[..., 7], g_rgb, g_depth,
        2 * fwd.weights, white)
    _grad_close(d_rgb, j_rgb)
    _grad_close(d_sigma, j_sigma)
    # the autograd Function that runs it on the CPU
    rgb_t = _t(rgb).requires_grad_()
    sigma_t = _t(sigma).requires_grad_()
    before = (composite_cuda.launches, composite_cuda.bwd_launches)
    o = composite_cuda.composite(rgb_t, sigma_t, _t(z), _t(rays), white)
    (torch.sum(o.rgb * torch.cos(o.rgb)) + torch.sum(o.depth * 0.7)
     + torch.sum(o.weights ** 2)).backward()
    assert (composite_cuda.launches, composite_cuda.bwd_launches) == before
    _grad_close(rgb_t.grad, j_rgb)
    _grad_close(sigma_t.grad, j_sigma)


def test_composite_function_takes_missing_cotangents_as_zero():
    # the train step reads only rgb: depth and weights hand no cotangent
    rgb, sigma, z, rays = _comp_case(4, 1, 50, 7)
    packed = _t(np.concatenate([rgb, sigma[..., None]], -1)).requires_grad_()
    o = composite_cuda.composite(packed[..., :3], packed[..., 3], _t(z),
                                 _t(rays), False)
    (o.rgb ** 2).sum().backward()
    j_rgb, j_sigma = jax.grad(
        lambda r, s: jnp.sum(jcomp.composite(r, s, jnp.asarray(z),
                                             jnp.asarray(rays)).rgb ** 2),
        argnums=(0, 1))(jnp.asarray(rgb), jnp.asarray(sigma))
    _grad_close(packed.grad[..., :3], j_rgb)
    _grad_close(packed.grad[..., 3], j_sigma)
    # a z that requires grad gets none, as in composite_pallas
    z_t = _t(z).requires_grad_()
    o = composite_cuda.composite(_t(rgb), _t(sigma).requires_grad_(), z_t,
                                 _t(rays), False)
    o.depth.sum().backward()
    assert z_t.grad is None


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_bilinear_imggrad_backward(C, dtype, mode):
    img, uv = _img_uv(11, C=C, P=400)
    rng = np.random.default_rng(12)
    g = rng.normal(0, 1, (2, 400, C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    j_img = jnp.asarray(img).astype(jdt)
    j_out, vjp = jax.vjp(lambda im, u: jgs.grid_sample_bilinear_imggrad(
        im, u, mode), j_img, jnp.asarray(uv))
    j_dimg, j_duv = vjp(jnp.asarray(g).astype(jdt))
    assert float(jnp.abs(j_duv).max()) == 0.0

    tdt = getattr(torch, dtype)
    t_img = _t(img).to(tdt).requires_grad_()
    t_uv = _t(uv).requires_grad_()
    out = tgs.grid_sample_bilinear_imggrad(t_img, t_uv, mode)
    assert out.dtype == tdt  # the same products summed in the same order
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(j_out.astype(jnp.float32)))
    out.backward(_t(g).to(tdt))
    assert t_img.grad.dtype == tdt and t_uv.grad is None
    ref = np.asarray(j_dimg.astype(jnp.float32))
    got = t_img.grad.float().numpy()
    if dtype == "float32":
        _close(got, ref)
    else:  # one bf16 ulp (2^-7 relative)
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


# ------------------------------------------------------------------- sampling

@pytest.fixture(scope="module")
def scene():
    """Sphere scene 32×40 with 2 views, target rays, view maps (numpy)."""
    b = make_sphere_scene(H=32, W=40, nv=2)
    H, W = 32, 40
    rays = np.asarray(j_gen_rays(
        jnp.asarray(b["target_extrinsics"]), jnp.asarray(b["target_intrinsics"]),
        W, H, jnp.asarray(b["znear"]), jnp.asarray(b["zfar"]))).reshape(
            1, H * W, 8)
    normals = np.asarray(j_depth_to_normal(
        jnp.asarray(b["src_depths"][0, ..., 0]),
        jnp.asarray(b["src_intrinsics"][0])))[None]
    intr = b["src_intrinsics"]
    maps = dict(depths=b["src_depths"], depth_stds=b["src_depth_stds"],
                normals=normals, poses=b["src_extrinsics"],
                focal=np.stack([intr[..., 0, 0], intr[..., 1, 1]], -1),
                c=intr[..., :2, 2],
                image_wh=np.array([W, H], np.float32))
    # every 3rd ray: a mix of sphere hits and background
    return rays[:, ::3].copy(), maps


def _views(maps):
    return (tsamp.ViewMaps(**{k: _t(v) for k, v in maps.items()}),
            jsamp.ViewMaps(**{k: jnp.asarray(v) for k, v in maps.items()}))


def test_stratified_z():
    rng = np.random.default_rng(5)
    rays = rng.uniform(0.5, 1.0, (2, 10, 8)).astype(np.float32)
    rays[..., 7] += 1.0
    u = rng.uniform(0, 1, (2, 10, 17)).astype(np.float32)
    _close(tsamp.stratified_z(_t(rays), 17, _t(u)),
           jsamp.stratified_z(jnp.asarray(rays), 17, jnp.asarray(u)))


def test_sample_view_maps_fused_matches_unfused_and_jax(scene):
    _, maps = scene
    tv, jv = _views(maps)
    rng = np.random.default_rng(6)
    # beyond [-1, 1] exercises border, zeros and the exponential ring
    uv = rng.uniform(-2.5, 2.5, (1, 2, 500, 2)).astype(np.float32)
    fused = tsamp.sample_view_maps_fused(tv, _t(uv))
    plain = tsamp.sample_view_maps(tv, _t(uv))
    j_fused = jsamp.sample_view_maps_fused(jv, jnp.asarray(uv))
    j_plain = jsamp.sample_view_maps(jv, jnp.asarray(uv))
    for a, b, c, d in zip(fused, plain, j_fused, j_plain):
        _close(a, b)
        _close(a, c)
        _close(b, d)


def test_surface_likelihood(scene):
    rays, maps = scene
    tv, jv = _views(maps)
    u = np.random.default_rng(7).uniform(0, 1, rays.shape[:2] + (64,))
    z = np.asarray(jsamp.stratified_z(jnp.asarray(rays), 64,
                                      jnp.asarray(u, jnp.float32)))
    lik, opaque = tsamp.surface_likelihood(_t(rays), tv, _t(z))
    j_lik, j_opaque = jsamp.surface_likelihood(jnp.asarray(rays), jv,
                                               jnp.asarray(z))
    assert (lik.numpy() > 0).sum() > 50  # the sphere is seen
    np.testing.assert_array_equal(lik.numpy() > 0, np.asarray(j_lik) > 0)
    _close(lik, j_lik)
    _close(opaque, j_opaque)


def test_weighted_mean_std_zero_weights():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 2, (3, 5, 9)).astype(np.float32)
    w = rng.uniform(0, 1, (3, 5, 9)).astype(np.float32)
    w[1, 2] = 0.0
    for a, b in zip(tsamp.weighted_mean_std(_t(x), _t(w)),
                    jsamp.weighted_mean_std(jnp.asarray(x), jnp.asarray(w))):
        _close(a, b)
        assert np.isfinite(a.numpy()).all()


def test_top_k_stable_breaks_ties_by_index():
    x = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.25, 0.0, 0.0]])
    vals, idx = tsamp.top_k_stable(x, 5)
    assert idx.tolist() == [[1, 3, 4, 0, 2]]
    assert vals.tolist() == [[0.5, 0.5, 0.25, 0.0, 0.0]]
    # many ties, as among zero likelihoods: same order as lax.top_k
    rng = np.random.default_rng(10)
    x = rng.integers(0, 3, (4, 50)).astype(np.float32)
    vals, idx = tsamp.top_k_stable(_t(x), 20)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 20)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


@pytest.mark.parametrize("n_gaussian", [0, 3])
def test_sample_depthguided_and_fill_up(scene, n_gaussian):
    rays, maps = scene
    tv, jv = _views(maps)
    NR = rays.shape[1]
    rng = np.random.default_rng(9)
    u_coarse = rng.uniform(0, 1, (1, NR, 64)).astype(np.float32)
    gauss = rng.normal(0, 1, (1, NR, 3)).astype(np.float32)
    u_fill = rng.uniform(0, 1, (1, NR, 8)).astype(np.float32)
    g = gauss[..., :n_gaussian] if n_gaussian else None
    z = tsamp.sample_depthguided(_t(rays), tv, 8, 64, _t(u_coarse),
                                 None if g is None else _t(g), n_gaussian)
    jz = jsamp.sample_depthguided(jnp.asarray(rays), jv, 8, 64,
                                  jnp.asarray(u_coarse),
                                  None if g is None else jnp.asarray(g),
                                  n_gaussian)
    # the same slots are empty (zero) and the shortlist is the same
    np.testing.assert_array_equal(z.numpy() == 0, np.asarray(jz) == 0)
    assert (z.numpy() != 0).any() and (z.numpy() == 0).any()
    _close(z, jz)
    zf = tsamp.fill_up_uniform(z, _t(rays), _t(u_fill))
    jzf = jsamp.fill_up_uniform(jz, jnp.asarray(rays), jnp.asarray(u_fill))
    assert (np.diff(zf.numpy(), axis=-1) >= 0).all()
    _close(zf, jzf)
