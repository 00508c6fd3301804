"""Port parity for KeypointNeRF's modules and renderer
(``diner_tpu_torch/models/keypointnerf/{modules,model}.py``,
``utils/resize.py:resize_bicubic_align_corners``) against the JAX package
on the CPU, at a small configuration, from the same numpy weights and
inputs. The pieces ``tests/test_torch_keypointnerf_step.py`` shares are
here too: the small configuration (``chip_smoke.KPN_SMALL``: 64×64
sources, geo_n_downsample 2, ngf 8 with one residual block, 8 keypoints
at sp_level 2, 8 + 8 samples, an 8×8 patch), the sphere batch, weights
drawn with numpy onto ``jax.eval_shape``'s tree (no op-by-op flax init)
and the replay of the JAX package's random draws.

Tolerances, all f32 (convolutions, matmuls and reductions sum in another
order in the two frameworks):

- the bicubic resize, ray–box clipping, target rays, keypoint encodings,
  compositing and resampling: 1e-5 absolute;
- WNLinear / MLPUNetFusion, the IBR head: 1e-5 absolute;
- the geometry and texture encoders: 1e-4 absolute (group and instance
  norms over a few hundred values each, in f32);
- ``query`` and ``render_rays``: 1e-4 absolute on colour, sdf and alpha,
  1e-4 relative on depth.

Every threshold decision is held for equality before any value: the
ray–box ``hit``, the out-of-view and foreground masks (``valid``), the
resampler's ``>=`` bins and the patch grid.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import KPN_SMALL
from diner_tpu.data.synthetic_dataset import SphereDataset as JSphereDataset
from diner_tpu.models.keypointnerf import losses as jlosses
from diner_tpu.models.keypointnerf import model as jmodel
from diner_tpu.models.keypointnerf import modules as jmod
from diner_tpu.models.keypointnerf.model import KeypointNeRF as JKeypointNeRF
from diner_tpu.models.keypointnerf.model import (
    KeypointNeRFConfig as JKeypointNeRFConfig)
from diner_tpu.models.keypointnerf.train import decode_cameras as j_decode
from diner_tpu.models.keypointnerf.train import target_rays as j_target_rays
from diner_tpu.models.keypointnerf.train import (
    training_patch_grid as j_patch_grid)
from diner_tpu.utils.resize import (
    resize_bicubic_align_corners as j_bicubic)
from diner_tpu_torch.models.keypointnerf import losses as tlosses
from diner_tpu_torch.models.keypointnerf import model as tmodel
from diner_tpu_torch.models.keypointnerf import modules as tmod
from diner_tpu_torch.models.keypointnerf.model import (KeypointNeRF,
                                                       KeypointNeRFConfig,
                                                       RenderNoise)
from diner_tpu_torch.models.keypointnerf.train import (decode_cameras,
                                                       target_rays,
                                                       training_patch_grid)
from diner_tpu_torch.utils.convert import keypointnerf_flax_to_state_dict
from diner_tpu_torch.utils.resize import resize_bicubic_align_corners


# ------------------------------------------------ shared with the step file

H = W = 64
SMALL = KPN_SMALL  # chip_smoke.py's small reference step runs it too


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while a module runs: the suite runs several
    workers at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def sphere_batch(seed=0, idx=1, n_kpt=8):
    """The JAX sphere's KeypointNeRF sample at 64×64, 2 views, as a batch
    of one (numpy), with seeded texture on the sources: on a flat image
    the normalizations divide by almost no variance."""
    s = JSphereDataset("train", n=4, H=H, W=W, nv=2, model="KeypointNeRF",
                       n_kpt=n_kpt)[idx]
    b = {k: np.asarray(v)[None] for k, v in s.items()
         if isinstance(v, np.ndarray)}
    rng = np.random.default_rng(seed)
    b["src_rgbs"] = np.clip(b["src_rgbs"] + rng.normal(
        0, 0.1, b["src_rgbs"].shape), 0, 1).astype(np.float32)
    b["target_rgb"] = np.clip(b["target_rgb"] + rng.normal(
        0, 0.1, b["target_rgb"].shape), 0, 1).astype(np.float32)
    return b


def draw_like(shapes, seed):
    """numpy weights on a flax tree of shapes: fan-in scaled kernels and
    WNLinear directions, g = ‖v‖ · (1 + 0.1 n), GroupNorm scales near 1,
    small biases, ani_al near 0.2."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = path[-1].key
        shape = tuple(x.shape)
        if name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        elif name == "ani_al":
            v = 0.2 + 0.05 * rng.randn()
        elif name == "g":
            v = np.ones(shape)  # set from v below
        else:  # kernel, v
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)

    def fix_g(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix_g(v) for k, v in node.items()}
        if "v" in node and "g" in node:
            node["g"] = (np.linalg.norm(node["v"], axis=0) * (
                1 + 0.1 * rng.randn(node["g"].shape[0]))).astype(np.float32)
        return node

    return fix_g(jax.tree_util.tree_map(np.asarray, tree))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def model_pair(b, seed=0, **over):
    """(flax model, its numpy params, the port's model with them)."""
    jm = JKeypointNeRF(cfg=JKeypointNeRFConfig(**{**SMALL, **over}))
    jb = jax_batch(b)
    B, V = b["src_rgbs"].shape[:2]
    imgs = jb["src_rgbs"].reshape(B * V, H, W, 3)
    cams = j_decode(jb, jm.cfg)

    def run(mdl):
        fg, ft = mdl.encode_features(imgs)
        o, d, zn, zf = j_target_rays(cams["cam_tar"], jnp.zeros((B, 16, 2)),
                                     jm.cfg.znear, jm.cfg.zfar, jb["bounds"])
        return mdl.render_rays(
            jnp.broadcast_to(o, d.shape), d, zn, zf, cams["cam"], fg, ft,
            imgs, jb["target_kpt3d"],
            jb["src_alphas"].reshape(B * V, H, W, 1), jax.random.PRNGKey(0),
            train=False)

    shapes = jax.eval_shape(lambda: fnn.init(run, jm)(jax.random.PRNGKey(0)))
    params = draw_like(shapes["params"], seed)
    tm = KeypointNeRF(KeypointNeRFConfig(**{**SMALL, **over}))
    tm.load_state_dict(keypointnerf_flax_to_state_dict({"params": params}))
    return jm, params, tm


def jax_render_noise(key, cfg, B, R, V) -> RenderNoise:
    """The draws the JAX package's ``render_rays`` takes from ``key``."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    Sc, Sf = cfg.sample_per_ray_c, cfg.sample_per_ray_f
    perm_key, _ = jax.random.split(k5)
    draws = (jax.random.uniform(k1, (B, R, Sc)),
             jax.random.normal(k2, (B, R * Sc, 1)),
             jax.random.uniform(k3, (B, R, Sf)),
             jax.random.normal(k4, (B, R * (Sc + Sf), 1)),
             jax.random.uniform(k5, (B, V - 1, 1, 1)),
             jax.random.uniform(perm_key, (B, V, 1, 1)))
    return RenderNoise(*(t(np.asarray(d)) for d in draws))


def jax_patch_center(key, mask):
    """The patch centre the JAX package's ``training_patch_grid`` draws
    from ``key`` (its Gumbel-max over the mask)."""
    B = mask.shape[0]
    logits = jnp.where(jnp.asarray(mask).reshape(B, -1) > 0, 0.0, -jnp.inf)
    return np.array(jax.random.categorical(key, logits, axis=-1))


# ---------------------------------------------------------- helpers

def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _flax_pair(jmodule, tmodule, *inputs, seed=0):
    """Draw a flax module's weights with numpy, load them into the port's
    module; returns (JAX output, port output) on ``inputs``."""
    jin = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0),
                                                 *jin))
    params = draw_like(shapes["params"], seed)
    tmodule.load_state_dict(keypointnerf_flax_to_state_dict(
        {"params": params}))
    ref = jax.jit(jmodule.apply)({"params": params}, *jin)
    with torch.no_grad():
        got = tmodule(*(t(x) for x in inputs))
    return ref, got


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("out_hw", [(10, 14), (7, 5)])
def test_resize_bicubic_matches_jax(out_hw):
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(j_bicubic(jnp.asarray(x), *out_hw))
    got = resize_bicubic_align_corners(t(x), *out_hw)
    assert got.shape == ref.shape
    _close(got, ref, 1e-5)
    # NCHW axes give the same values
    nchw = resize_bicubic_align_corners(t(x).permute(0, 3, 1, 2), *out_hw,
                                        axes=(-2, -1))
    _close(nchw.permute(0, 2, 3, 1), ref, 1e-5)


def test_mlp_unet_fusion_matches_jax():
    rng = np.random.RandomState(1)
    B, V, N = 1, 3, 40
    x = rng.randn(B, V, N, 20).astype(np.float32)
    feats = [rng.randn(B, V, N, 16).astype(np.float32),
             rng.randn(B, V, N, 8).astype(np.float32)]
    a = (rng.rand(B, V, N, 1) > 0.3).astype(np.float32)
    w = rng.rand(B, V, N, 1).astype(np.float32) * a
    kw = dict(n_dims1=(20, 32, 32, 24, 16), n_dims2=(32, 16, 16, 2),
              skip_dims=(16, 8), skip_layers=(0, 2),
              pool_types=("mean", "var"))
    jm = jmod.MLPUNetFusion(**kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), [jnp.asarray(f) for f in feats],
        jnp.asarray(a), jnp.asarray(w)))
    params = draw_like(shapes["params"], 2)
    tm = tmod.MLPUNetFusion(**kw)
    tm.load_state_dict(keypointnerf_flax_to_state_dict({"params": params}))
    # the last layers are plain dense ones, the others weight-normed
    assert "layers1.layer_3.linear.weight" in tm.state_dict()
    assert tm.layers1.layer_0.v.shape == (36, 32)
    for weights in (w, None):
        ref = jm.apply({"params": params}, jnp.asarray(x),
                       [jnp.asarray(f) for f in feats], jnp.asarray(a),
                       None if weights is None else jnp.asarray(weights))
        with torch.no_grad():
            got = tm(t(x), [t(f) for f in feats], t(a),
                     None if weights is None else t(weights))
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            else:
                _close(g, r, 1e-5)


def test_wnlinear_init_is_flax_family():
    lin = tmod.WNLinear(50, 7)
    tmod.reset_all(lin, torch.Generator().manual_seed(0))
    v = lin.v.detach()
    assert v.shape == (50, 7) and torch.equal(lin.bias.detach(),
                                              torch.zeros(7))
    torch.testing.assert_close(lin.g.detach(), torch.linalg.norm(v, dim=0))
    # lecun normal: std sqrt(1 / fan_in), truncated at 2 std
    assert abs(float(v.std()) - 50 ** -0.5) < 0.03
    assert float(v.abs().max()) <= 2 * 50 ** -0.5 / 0.8796 + 1e-6
    x = torch.randn(4, 50)
    # with g = ‖v‖ the layer is x @ v + b
    torch.testing.assert_close(lin(x), x @ v)


def test_hgfilter_matches_jax():
    x = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)
                                         ).astype(np.float32)
    ref, got = _flax_pair(jmod.HGFilterV2(out_ch=16, n_downsample=2),
                          tmod.HGFilterV2(out_ch=16, n_downsample=2), x)
    assert [g.shape for g in got] == [(2, 8, 8, 16), (2, 32, 32, 8)]
    for g, r in zip(got, ref):
        assert float(np.abs(np.asarray(r)).max()) > 0.1
        _close(g, r, 1e-4)


def test_resblk_encoder_matches_jax():
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)
                                         ).astype(np.float32)
    ref, got = _flax_pair(jmod.ResBlkEncoder(ngf=8, n_blocks=1),
                          tmod.ResBlkEncoder(ngf=8, n_blocks=1), x)
    assert got.shape == (2, 16, 16, 8)
    _close(got, ref, 1e-4)


def test_ibr_head_matches_jax():
    rng = np.random.RandomState(5)
    R, S, V, F = 6, 4, 3, 35
    feats = rng.rand(R, S, V, F).astype(np.float32)
    diffs = (rng.randn(R, S, V, 4) * 0.3).astype(np.float32)
    mask = (rng.rand(R, S, V, 1) > 0.3).astype(np.float32)
    mask[0, 0] = 0  # a sample no view sees: a uniform softmax
    ref, got = _flax_pair(jmod.IBRRenderingHead(in_channels=32),
                          tmod.IBRRenderingHead(32, F), feats, diffs, mask)
    assert got.shape == (R, S, 3)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("sp_level", [1, 2])
def test_rel_z_decay_encoding_matches_jax(sp_level):
    rng = np.random.RandomState(6)
    cxyz = (rng.randn(2, 30, 3) * 0.1).astype(np.float32)
    kpt = (rng.randn(2, 8, 3) * 0.1).astype(np.float32)
    ref = jmod.rel_z_decay_encoding(jnp.asarray(cxyz), jnp.asarray(kpt),
                                    sp_level, 1.0, 0.05)
    got = tmod.rel_z_decay_encoding(t(cxyz), t(kpt), sp_level, 1.0, 0.05)
    assert got.shape == (2, 30, (1 + 2 * sp_level) * 8)
    assert float(np.abs(np.asarray(ref)).max()) > 0.01
    _close(got, ref, 1e-5)


def test_rgba2out_matches_jax():
    rng = np.random.RandomState(7)
    rgba = rng.rand(2, 5, 9, 5).astype(np.float32) * [4, 1, 1, 1, 1]
    z = np.sort(rng.rand(2, 5, 9).astype(np.float32) * 2 + 1, axis=-1)
    ref = jmodel.rgba2out(jnp.asarray(rgba), jnp.asarray(z))
    got = tmodel.rgba2out(t(rgba), t(z))
    for g, r in zip(got, ref):
        _close(g, r, 1e-5)


def test_pix_loss_and_mask_mse_match_jax():
    rng = np.random.RandomState(10)
    src = rng.rand(2, 8, 8, 3).astype(np.float32)
    tar = rng.rand(2, 8, 8, 3).astype(np.float32)
    w = {"l1": 1.0, "l2": 0.5, "lp": 0.3, "l1top25": 2.0, "l2top10": 1.5,
         "l2top0": 0.0}
    ref = jlosses.pix_loss(jnp.asarray(src), jnp.asarray(tar), w)
    got = tlosses.pix_loss(t(src), t(tar), w)
    assert sorted(got) == sorted(ref) == ["l1", "l1top25", "l2", "l2top10",
                                          "lp"]
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6,
                                   err_msg=k)
    with pytest.raises(KeyError):
        tlosses.pix_loss(t(src), t(tar), {"l3": 1.0})
    alpha = rng.rand(2, 64).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_allclose(
        float(tlosses.mask_mse(t(alpha), t(alpha > 0.5).float())),
        float(jlosses.mask_mse(jnp.asarray(alpha),
                               jnp.asarray((alpha > 0.5).astype(np.float32)))),
        rtol=1e-6)


@pytest.mark.parametrize("uniform", [True, False])
def test_importance_sample_matches_jax(uniform):
    rng = np.random.RandomState(8)
    contrib = rng.rand(1, 6, 14).astype(np.float32) ** 3
    z = np.sort(rng.rand(1, 6, 15).astype(np.float32) + 1, axis=-1)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jmodel.importance_sample(
        jnp.asarray(contrib), jnp.asarray(z), 8, key, uniform=uniform))
    u = None if uniform else t(np.asarray(jax.random.uniform(key, (1, 6, 8))))
    got = tmodel.importance_sample(t(contrib), t(z), 8, u=u)
    # the bins (searchsorted's >=) first, then the values
    cdf = np.concatenate([np.zeros((1, 6, 1)), np.cumsum(
        (contrib + 1e-5) / (contrib + 1e-5).sum(-1, keepdims=True), -1)],
        -1).astype(np.float32)
    sample = (np.linspace(0, 1, 8, dtype=np.float32) if uniform
              else u.numpy())
    bins = tmodel._batched_searchsorted(t(cdf), t(np.broadcast_to(
        sample, (1, 6, 8)).copy()))
    jbins = jmodel._batched_searchsorted(jnp.asarray(cdf), jnp.asarray(
        np.broadcast_to(sample, (1, 6, 8))))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    _close(got, ref, 1e-5)
    if uniform:  # jnp.linspace bit for bit
        np.testing.assert_array_equal(
            tmodel.linspace01(64).numpy(), np.asarray(jnp.linspace(0, 1, 64)))


def test_ray_bbox_intersection_matches_jax():
    rng = np.random.RandomState(9)
    bounds = np.array([[[-0.7, -0.6, -0.5], [0.7, 0.6, 0.5]]], np.float32)
    orig = np.array([[[0.2, 0.1, -2.0]]], np.float32)
    d = rng.randn(1, 200, 3).astype(np.float32) * [0.4, 0.4, 0.1] + [0, 0, 1]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0, :3] = [[1, 0, 0], [0, 0, 1], [0, 0, -1]]  # parallel, through, away
    ref = jmodel.ray_bbox_intersection(jnp.asarray(bounds), jnp.asarray(orig),
                                       jnp.asarray(d))
    got = tmodel.ray_bbox_intersection(t(bounds), t(orig), t(d))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].sum()) < 200
    _close(got[0], ref[0], 1e-5)
    _close(got[1], ref[1], 1e-5)


# ------------------------------------------------------------ cameras

@pytest.fixture(scope="module")
def batch():
    return sphere_batch()


def _patch(b, key=jax.random.PRNGKey(11)):
    center = jax_patch_center(key, b["target_mask"])
    ref = np.asarray(j_patch_grid(jnp.asarray(b["target_mask"]), 8, 8, key))
    return center, ref


def test_training_patch_grid_from_replayed_center(batch):
    for key in (jax.random.PRNGKey(11), jax.random.PRNGKey(12)):
        center, ref = _patch(batch, key)
        got = training_patch_grid(t(batch["target_mask"]), 8, 8, t(center))
        np.testing.assert_array_equal(got.numpy(), ref)
    # a centre at the corner clips to [0, min(W, H) - 1]
    got = training_patch_grid(t(batch["target_mask"]), 8, 8,
                              torch.tensor([H * W - 1]))
    assert float(got.max()) == min(W, H) - 1 and float(got.min()) >= 0


def test_target_rays_match_jax(batch):
    jb = jax_batch(batch)
    _, grids = _patch(batch)
    grids = np.concatenate([grids, np.array([[[0.0, 0.0], [63, 2]]],
                                            np.float32)], 1)  # misses
    ref = j_target_rays(j_decode(jb, None)["cam_tar"], jnp.asarray(grids),
                        0.8, 2.4, jb["bounds"])
    cams = decode_cameras({k: t(v) for k, v in batch.items()})
    got = target_rays(cams["cam_tar"], t(grids), 0.8, 2.4, t(batch["bounds"]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close(g, r, 1e-5)


# ------------------------------------------------------ the model

@pytest.fixture(scope="module")
def pair(batch):
    jm, params, tm = model_pair(batch)
    jb = jax_batch(batch)
    imgs = jb["src_rgbs"].reshape(2, H, W, 3)
    fg, ft = jax.jit(lambda p, im: jm.apply({"params": p}, im,
                                            method="encode_features"))(
        params, imgs)
    return dict(jm=jm, params=params, tm=tm, jb=jb,
                feat_geo=[np.asarray(f) for f in fg], feat_tex=np.asarray(ft))


def test_encode_features_match_jax(pair, batch):
    with torch.no_grad():
        fg, ft = pair["tm"].encode_features(
            t(batch["src_rgbs"]).reshape(2, H, W, 3))
    assert [f.shape for f in fg] == [(2, 8, 8, 16), (2, 32, 32, 8)]
    assert ft.shape == (2, 16, 16, 8) and ft.is_contiguous()
    for g, r in zip(fg + [ft], pair["feat_geo"] + [pair["feat_tex"]]):
        _close(g, r, 1e-4)


def _rays(batch, jb, n_rays=24):
    """Target rays through the patch of ``_patch`` and a few off it."""
    _, grids = _patch(batch)
    grids = grids[:, :n_rays]
    o, d, zn, zf = j_target_rays(j_decode(jb, None)["cam_tar"],
                                 jnp.asarray(grids), 0.8, 2.4, jb["bounds"])
    return [np.asarray(x) for x in (jnp.broadcast_to(o, d.shape), d, zn, zf)]


def _port_inputs(pair, batch):
    cams = decode_cameras({k: t(v) for k, v in batch.items()})
    return (cams["cam"], [t(f) for f in pair["feat_geo"]],
            t(pair["feat_tex"]), t(batch["src_rgbs"]).reshape(2, H, W, 3),
            t(batch["target_kpt3d"]), t(batch["src_alphas"]).reshape(
                2, H, W, 1))


def _jax_inputs(pair):
    jb = pair["jb"]
    return (j_decode(jb, None)["cam"], [jnp.asarray(f) for f in
                                        pair["feat_geo"]],
            jnp.asarray(pair["feat_tex"]), jb["src_rgbs"].reshape(2, H, W, 3),
            jb["target_kpt3d"], jb["src_alphas"].reshape(2, H, W, 1))


@pytest.mark.parametrize("train", [False, True])
def test_query_matches_jax(pair, batch, train):
    o, d, zn, zf = _rays(batch, pair["jb"])
    S = 6
    s = np.linspace(0, 1, S, dtype=np.float32)
    z = zn + (zf - zn) * s
    pts = (o[:, :, None] + d[:, :, None] * z[..., None]).reshape(1, -1, 3)
    view = np.broadcast_to(d[:, :, None], (1, d.shape[1], S, 3)
                           ).reshape(1, -1, 3)
    key = jax.random.PRNGKey(5)
    ref, jvalid = jax.jit(lambda p, *a: pair["jm"].apply(
        {"params": p}, *a, S, train, dropout_key=key if train else None,
        method="query"))(pair["params"], jnp.asarray(pts), jnp.asarray(view),
                         *_jax_inputs(pair))
    # query's dropout reads its key directly: keep from the key, perm from
    # its first split
    perm_key, _ = jax.random.split(key)
    dropout = (t(np.asarray(jax.random.uniform(key, (1, 1, 1, 1)))),
               t(np.asarray(jax.random.uniform(perm_key, (1, 2, 1, 1)))))
    cam, fg, ft, imgs, kpt, mask = _port_inputs(pair, batch)
    with torch.no_grad():
        got, valid = pair["tm"].query(t(pts), t(view), cam, fg, ft, imgs,
                                      kpt, mask, S, train,
                                      dropout=dropout if train else None)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < int(valid.sum()) < valid.numel()
    assert got.shape == (1, pts.shape[1], 5)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_render_rays_matches_jax(pair, batch, train):
    o, d, zn, zf = _rays(batch, pair["jb"])
    key = jax.random.PRNGKey(9)
    ref = jax.jit(lambda p, *a: pair["jm"].apply(
        {"params": p}, *a, key, train, method="render_rays"))(
        pair["params"], *(jnp.asarray(x) for x in (o, d, zn, zf)),
        *_jax_inputs(pair))
    noise = (jax_render_noise(key, pair["jm"].cfg, 1, d.shape[1], 2)
             if train else None)
    with torch.no_grad():
        got = pair["tm"].render_rays(*(t(x) for x in (o, d, zn, zf)),
                                     *_port_inputs(pair, batch), train,
                                     noise=noise)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        if k.startswith("depth"):
            np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-4,
                                       err_msg=k)
        else:
            _close(got[k], r, 1e-4)
    assert float(ref["alpha_fine"].max()) > 0.05
