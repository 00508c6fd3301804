"""Port parity for the conditioned field and the renderer.

A small DINER (resnet18 with 2 pyramid levels, 8 px image padding, a
32-wide ResnetFC) is initialized in flax, its weights and BN statistics
perturbed with seeded numpy noise, and bridged to the port. Both packages
then encode the 32×40 two-view sphere scene, query the field and render;
the renderer's noise is drawn with ``jax.random`` from the key splits of
``diner_tpu/renderer/renderer.py:77-84`` and ``:142`` and handed to the
port. Tolerance: 1e-4 on everything downstream of the convolutions and
matmuls (f32 sums in another order); the depth-guided shortlist must pick
the same samples, so z-dependent outputs agree at that tolerance too.
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from diner_tpu.geometry import gen_rays as j_gen_rays
from diner_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
from diner_tpu.models.pixelnerf import PixelNeRFConfig as JPixelNeRFConfig
from diner_tpu.nn.spatial_encoder import SpatialEncoderConfig as JEncCfg
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.renderer import render_rays as j_render_rays
from diner_tpu.renderer import render_rays_chunked as j_render_rays_chunked
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.renderer import (RendererConfig, render_rays,
                                      render_rays_chunked)
from diner_tpu_torch.utils.convert import flax_to_state_dict

H, W = 32, 40
ENC = dict(backbone="resnet18", num_layers=2, image_padding=8, padding_pe=4)
RENDER = dict(n_samples=8, n_depth_candidates=64, n_gaussian=3,
              white_bkgd=False)
SRC = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
       "src_intrinsics")
ATOL = 1e-4


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x + rng.normal(0, 0.05, x.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))
    return jax.tree_util.tree_map(
        np.asarray, {k: dict(v) for k, v in tree.items()})


def small_pair(seed=0):
    """(batch, jax model, flax variables, port model with the same weights,
    jax config, port config)."""
    batch = make_sphere_scene(H=H, W=W, nv=2)
    # texture the flat white background: on a constant image some BN
    # channels have almost no variance and amplify rounding ~300-fold
    rng = np.random.default_rng(seed)
    batch["src_rgbs"] = np.clip(batch["src_rgbs"] + rng.normal(
        0, 0.1, batch["src_rgbs"].shape), 0, 1).astype(np.float32)
    jcfg = JPixelNeRFConfig(encoder=JEncCfg(**ENC), d_hidden=32)
    jm = JPixelNeRF(cfg=jcfg)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 *(jnp.asarray(batch[k]) for k in SRC),
                                 jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    variables = _perturbed(variables, seed + 100)
    cfg = PixelNeRFConfig(encoder=SpatialEncoderConfig(**ENC), d_hidden=32)
    tm = PixelNeRF(cfg)
    tm.load_state_dict(flax_to_state_dict(variables))
    return batch, jm, variables, tm


def jax_chunk_noise(key, SB, NR, chunk, rcfg):
    """The noise ``render_rays_chunked`` draws in JAX, as whole-image arrays
    over the padded ray axis."""
    n_chunks = -(-NR // chunk)
    parts = []
    for k in jax.random.split(key, n_chunks):
        parts.append(jax_noise(k, SB, chunk, rcfg))
    return tuple(np.concatenate([p[i] for p in parts], axis=1)
                 for i in range(3))


def jax_noise(key, SB, NR, rcfg):
    k_coarse, k_gauss, k_fill = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(
                k_coarse, (SB, NR, rcfg.n_depth_candidates))),
            np.asarray(jax.random.normal(k_gauss, (SB, NR, rcfg.n_gaussian))),
            np.asarray(jax.random.uniform(k_fill, (SB, NR, rcfg.n_samples))))


def target_rays(batch):
    return np.asarray(j_gen_rays(
        jnp.asarray(batch["target_extrinsics"]),
        jnp.asarray(batch["target_intrinsics"]), W, H,
        jnp.asarray(batch["znear"]), jnp.asarray(batch["zfar"]))).reshape(
            1, H * W, 8)


@pytest.fixture(scope="module")
def pair():
    batch, jm, variables, tm = small_pair()
    jctx, _ = jax.jit(lambda v, *src: jm.apply(
        v, *src, train=True, method="encode", mutable=["batch_stats"]))(
            variables, *(jnp.asarray(batch[k]) for k in SRC))
    with torch.no_grad():
        tctx = tm.encode(*(torch.from_numpy(batch[k]) for k in SRC))

    def jfield(c, xyz, vd):
        return jm.apply(variables, c, xyz, vd, method="field")

    return types.SimpleNamespace(batch=batch, jm=jm, variables=variables,
                                 tm=tm, jctx=jctx, tctx=tctx, jfield=jfield,
                                 rays=target_rays(batch))


def test_encode(pair):
    j, t = pair.jctx, pair.tctx
    assert t.latent.shape == j.latent.shape == (1, 2, 24, 28, 128)
    _close(t.latent, j.latent)
    for name in ("normals", "focal", "c", "image_wh"):
        _close(getattr(t, name), getattr(j, name), 1e-5)
    assert t.feature_padding == j.feature_padding == 4


def test_field(pair):
    # points along every 5th target ray, near and far of the sphere
    rays = pair.rays[:, ::5]
    t = np.linspace(0.1, 0.9, 6, dtype=np.float32)[:, None]
    xyz = (rays[:, :, None, :3] + (rays[:, :, None, 6:7] * (1 - t)
                                   + rays[:, :, None, 7:8] * t)
           * rays[:, :, None, 3:6]).reshape(1, -1, 3)
    dirs = np.broadcast_to(rays[:, :, None, 3:6],
                           rays.shape[:2] + (6, 3)).reshape(1, -1, 3)
    ref = pair.jfield(pair.jctx, jnp.asarray(xyz), jnp.asarray(dirs))
    with torch.no_grad():
        out = pair.tm.field(pair.tctx, torch.from_numpy(xyz),
                            torch.from_numpy(np.ascontiguousarray(dirs)))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out[..., 3] > 0).any()  # the density head is alive
    _close(out, ref)


@pytest.mark.parametrize("white", [False, True])
def test_render_rays(pair, white):
    rcfg = dict(RENDER, white_bkgd=white)
    rays = pair.rays[:, ::6]
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda c, r, k: j_render_rays(
        pair.jfield, c, r, k, JRendererConfig(**rcfg), want_weights=True))(
            pair.jctx, jnp.asarray(rays), key)
    noise = tuple(torch.tensor(a) for a in
                  jax_noise(key, 1, rays.shape[1], JRendererConfig(**rcfg)))
    with torch.no_grad():
        out = render_rays(pair.tm.field, pair.tctx, torch.tensor(rays),
                          RendererConfig(**rcfg), noise=noise,
                          want_weights=True)
    assert (out.depth > 0).any()
    for a, b in zip(out, ref):
        _close(a, b)


def test_render_rays_chunked_ragged(pair):
    # 300 rays in chunks of 128: 3 chunks, the last one edge-padded
    rcfg = dict(RENDER, ray_chunk=128)
    rays = pair.rays[:, 400:700]
    key = jax.random.PRNGKey(11)
    ref = j_render_rays_chunked(pair.jfield, pair.jctx, jnp.asarray(rays),
                                key, JRendererConfig(**rcfg))
    noise = jax_chunk_noise(key, 1, 300, 128, JRendererConfig(**rcfg))
    noise = tuple(torch.tensor(a[:, :300]) for a in noise)
    with torch.no_grad():
        out = render_rays_chunked(pair.tm.field, pair.tctx,
                                  torch.tensor(rays),
                                  RendererConfig(**rcfg), noise=noise)
    assert out.rgb.shape == (1, 300, 3) and out.weights is None
    _close(out.rgb, ref.rgb)
    _close(out.depth, ref.depth)


def test_render_rays_draws_from_generator(pair):
    rays = torch.tensor(pair.rays[:, ::20])
    cfg = RendererConfig(**RENDER)
    with torch.no_grad():
        a = render_rays(pair.tm.field, pair.tctx, rays, cfg,
                        generator=torch.Generator().manual_seed(3))
        b = render_rays(pair.tm.field, pair.tctx, rays, cfg,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.rgb, b.rgb) and torch.isfinite(a.rgb).all()


def test_renderer_config_rejects_unknown_composite():
    with pytest.raises(ValueError):
        RendererConfig(composite_impl="triton")
