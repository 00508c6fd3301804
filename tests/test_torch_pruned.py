"""Port parity for the pruned two-stage sampler, alone, in the renderer and
in a production train step.

``sample_depthguided_pruned`` gets the same rays, view maps, uniforms and
normals in both packages, on the JAX package's own sampler fixture
(``tests/test_sampling.py:_make_scene``: n_candidates 200, 25 coarse bins,
8 refine bins, 24 samples, with and without 6 Gaussian resamples) and on a
variant in which half of every view map is a hole, so that many rays and
most coarse bins have exactly zero likelihood: there the refined bins are
chosen among ties, in ``lax.top_k``'s (−value, index) order. Tolerance
1e-6 (the same f32 arithmetic; the shortlists must pick the same samples).
The render and the train step take the tolerances of
``tests/test_torch_render.py`` (1e-4) and ``tests/test_torch_train.py``
(metrics 1e-5 relative, each gradient within 1e-4 of its norm).
"""

import copy
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from diner_tpu.losses import init_vgg19_params
from diner_tpu.ops import sampling as jsamp
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.renderer import render_rays as j_render_rays
from diner_tpu.train.diner import DinerConfig as JDinerConfig
from diner_tpu.train.diner import compute_losses as j_compute_losses
from diner_tpu.train.diner import select_pixels as j_select_pixels
from diner_tpu_torch.losses import VGG19Features
from diner_tpu_torch.ops import sampling as tsamp
from diner_tpu_torch.renderer import RendererConfig, render_rays
from diner_tpu_torch.train.diner import DinerConfig, make_train_step
from diner_tpu_torch.utils.convert import flax_to_state_dict
from test_sampling import _make_scene
from test_torch_render import RENDER, SRC, jax_noise, small_pair, target_rays

TOL = 1e-6
# the render fixture's 64 candidates: 16 coarse bins of 4, the best 4 refined
PRUNED = dict(n_coarse_candidates=16, n_refine_bins=4)


def _views(scene):
    return tsamp.ViewMaps(
        depths=torch.from_numpy(scene["depths"]),
        depth_stds=torch.from_numpy(scene["stds"]),
        normals=torch.from_numpy(scene["normals"]),
        poses=torch.from_numpy(scene["poses"]),
        focal=torch.from_numpy(scene["focal"]),
        c=torch.from_numpy(np.ascontiguousarray(scene["c"])),
        image_wh=torch.tensor([float(scene["W"]), float(scene["H"])]))


def _jviews(scene):
    return jsamp.ViewMaps(**{k: jnp.asarray(v) for k, v in
                             tsamp.ViewMaps._asdict(_views(scene)).items()})


def _holed_scene(seed=7):
    """The JAX fixture with the left half of every map a hole (depth, std
    and normal zero) and rays spread over both halves."""
    rays, _, scene = _make_scene(seed=seed, NR=64)
    W = scene["W"]
    for k in ("depths", "stds", "normals"):
        scene[k] = scene[k].copy()
        scene[k][:, :, :, : W // 2] = 0.0
    dirs = rays[..., 3:6].copy()
    dirs[..., 0] = np.linspace(-0.25, 0.25, rays.shape[1])
    rays[..., 3:6] = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return rays, scene


def _fixture(name):
    if name == "jax_tests":
        rays, _, scene = _make_scene()
    else:
        rays, scene = _holed_scene()
    return rays, scene


@pytest.mark.parametrize("fixture", ["jax_tests", "zero_ties"])
@pytest.mark.parametrize("n_gauss", [0, 6])
def test_pruned_sampler_matches_jax(fixture, n_gauss):
    rays, scene = _fixture(fixture)
    SB, NR = rays.shape[:2]
    n_cand, n_coarse, n_bins, n_samples = 200, 25, 8, 24
    rng = np.random.default_rng(2 + n_gauss)
    u = rng.uniform(0, 1, (SB, NR, n_cand)).astype(np.float32)
    gn = rng.normal(0, 1, (SB, NR, n_gauss)).astype(np.float32)
    g = (torch.from_numpy(gn), jnp.asarray(gn)) if n_gauss else (None, None)
    z = tsamp.sample_depthguided_pruned(
        torch.from_numpy(rays), _views(scene), n_samples, n_cand, n_coarse,
        n_bins, torch.from_numpy(u), g[0], n_gauss)
    jz = np.asarray(jsamp.sample_depthguided_pruned(
        jnp.asarray(rays), _jviews(scene), n_samples, n_cand, n_coarse,
        n_bins, jnp.asarray(u), g[1], n_gauss))
    assert z.shape == (SB, NR, n_samples) and not z.requires_grad
    np.testing.assert_array_equal(z.numpy() == 0, jz == 0)
    np.testing.assert_allclose(z.numpy(), jz, atol=TOL, rtol=0)
    live = (jz[..., :n_samples - n_gauss] != 0).any(-1)
    assert live.any()
    if fixture == "zero_ties":  # many rays see only the hole
        assert (~live).sum() >= NR // 4


def test_pruned_sampler_matches_full():
    """The JAX package's test on the port: with the fixture's smooth maps
    the two-stage shortlist selects the one-stage sampler's z set."""
    rays, _, scene = _make_scene()
    SB, NR = rays.shape[:2]
    n_cand, n_coarse, n_bins, n_samples = 200, 25, 8, 24
    u = torch.from_numpy(np.random.RandomState(2).rand(
        SB, NR, n_cand).astype(np.float32))
    r = torch.from_numpy(rays)
    full = tsamp.sample_depthguided(r, _views(scene), n_samples, n_cand, u)
    pruned = tsamp.sample_depthguided_pruned(r, _views(scene), n_samples,
                                             n_cand, n_coarse, n_bins, u)
    assert (full > 0).any(), "fixture produced no surface hits"
    np.testing.assert_allclose(np.sort(pruned.numpy(), -1),
                               np.sort(full.numpy(), -1), atol=1e-6)


def test_pruned_sampler_gaussian_stats_close():
    """The JAX package's test on the port: the coarse-profile Gaussian fit
    tracks the fine-profile fit."""
    rays, _, scene = _make_scene(seed=3)
    SB, NR = rays.shape[:2]
    n_cand, n_coarse, n_bins, n_samples, n_gauss = 200, 25, 8, 24, 6
    rng = np.random.RandomState(4)
    u = torch.from_numpy(rng.rand(SB, NR, n_cand).astype(np.float32))
    gn = torch.from_numpy(rng.randn(SB, NR, n_gauss).astype(np.float32))
    r = torch.from_numpy(rays)
    full = tsamp.sample_depthguided(r, _views(scene), n_samples, n_cand, u,
                                    gn, n_gauss).numpy()
    pruned = tsamp.sample_depthguided_pruned(
        r, _views(scene), n_samples, n_cand, n_coarse, n_bins, u, gn,
        n_gauss).numpy()
    np.testing.assert_allclose(np.sort(pruned[..., :-n_gauss], -1),
                               np.sort(full[..., :-n_gauss], -1), atol=1e-6)
    ray_range = float(rays[0, 0, 7] - rays[0, 0, 6])
    both_live = (np.abs(full[..., -n_gauss:]) > 0) \
        & (np.abs(pruned[..., -n_gauss:]) > 0)
    assert both_live.any()
    diff = np.abs(pruned[..., -n_gauss:] - full[..., -n_gauss:])[both_live]
    assert diff.max() < 0.05 * ray_range, diff.max()


def test_renderer_config_checks_the_pruned_counts():
    # ADVICE.md: the tiny pipeline's 64 candidates with 125 coarse bins
    # crashed mid-render in the JAX package; here the config refuses them
    with pytest.raises(ValueError, match="multiple"):
        RendererConfig(n_samples=8, n_depth_candidates=64, n_gaussian=3,
                       n_coarse_candidates=125)
    with pytest.raises(ValueError, match="cannot hold"):  # 4 · 8 < 40
        RendererConfig(n_coarse_candidates=125, n_refine_bins=4)
    with pytest.raises(ValueError, match="cannot hold"):  # more bins than 25
        RendererConfig(n_samples=24, n_depth_candidates=200, n_gaussian=6,
                       n_coarse_candidates=25, n_refine_bins=30)
    # the headline configs and the one-stage default are accepted
    RendererConfig(n_coarse_candidates=125, n_refine_bins=16)
    RendererConfig(n_samples=64, n_gaussian=24, n_coarse_candidates=125)
    RendererConfig(n_samples=8, n_depth_candidates=64, n_gaussian=3)


# ------------------------------------------------------------- the renderer

@pytest.fixture(scope="module")
def render_pair():
    batch, jm, variables, tm = small_pair()
    jctx, _ = jax.jit(lambda v, *src: jm.apply(
        v, *src, train=True, method="encode", mutable=["batch_stats"]))(
            variables, *(jnp.asarray(batch[k]) for k in SRC))
    with torch.no_grad():
        tctx = tm.encode(*(torch.from_numpy(batch[k]) for k in SRC))
    return types.SimpleNamespace(
        tm=tm, jctx=jctx, tctx=tctx, rays=target_rays(batch),
        jfield=lambda c, xyz, vd: jm.apply(variables, c, xyz, vd,
                                           method="field"))


@pytest.mark.parametrize("white", [False, True])
def test_render_rays_pruned_matches_jax(render_pair, white):
    rcfg = dict(RENDER, white_bkgd=white, **PRUNED)
    rays = render_pair.rays[:, ::6]
    key = jax.random.PRNGKey(9)
    jcfg = JRendererConfig(**rcfg)
    ref = jax.jit(lambda c, r, k: j_render_rays(
        render_pair.jfield, c, r, k, jcfg, want_weights=True))(
            render_pair.jctx, jnp.asarray(rays), key)
    noise = tuple(torch.tensor(a) for a in
                  jax_noise(key, 1, rays.shape[1], jcfg))
    with torch.no_grad():
        out = render_rays(render_pair.tm.field, render_pair.tctx,
                          torch.tensor(rays), RendererConfig(**rcfg),
                          noise=noise, want_weights=True)
    assert (out.depth > 0).any()
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4,
                                   rtol=0)


# ------------------------------------------------------------ the train step

def test_production_train_step_pruned_matches_jax():
    batch, jm, variables, tm = small_pair(seed=2)
    vgg_params = jax.tree_util.tree_map(np.asarray, init_vgg19_params(0))
    extra = dict(w_vgg=0.1, vgg_spatch=16, w_antibias=1.0,
                 antibias_downsampling=3)
    jcfg = JDinerConfig(nerf=jm.cfg,
                        renderer=JRendererConfig(**RENDER, **PRUNED), **extra)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(23)
    (j_total, aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_compute_losses(jm, jcfg, p, variables["batch_stats"],
                                   vgg_params, jbatch, key),
        has_aux=True))(variables["params"])
    k_pix, k_render = jax.random.split(key)
    pix = np.array(j_select_pixels(jcfg, jbatch, k_pix))
    noise = tuple(np.array(a) for a in jax_noise(
        k_render, 1, jcfg.rays_per_step, jcfg.renderer))

    cfg = DinerConfig(nerf=tm.cfg, renderer=RendererConfig(**RENDER, **PRUNED),
                      **extra)
    tm = copy.deepcopy(tm)
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict({"params": vgg_params}))
    metrics = make_train_step(tm, cfg, vgg)(batch, noise=noise,
                                            pix_idcs=pix)

    j_metrics = aux["metrics"]
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   atol=0)
    ref = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref)
    nonzero = 0
    for k, p in named.items():
        g, jg = p.grad.numpy(), ref[k].numpy()
        nonzero += bool(np.abs(jg).max() > 0)
        np.testing.assert_allclose(
            g, jg, atol=1e-4 * np.linalg.norm(jg) + 1e-9, rtol=0, err_msg=k)
    assert nonzero > len(named) // 2
