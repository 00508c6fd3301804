"""Port parity for NOVEL / NOVEL_PE: the top-1 kNN and the mesh
deformation, both samplers with a deformation, the field, the renderer,
one train step, the dense keypoint regressor, the sphere's NOVEL schemas
and the training CLI.

A small NOVEL (resnet18 with 2 pyramid levels, 8 px image padding, a
32-wide ResnetFC, a 16×16 gen-latent plane of 128 channels) is
initialized in flax, its weights and BN statistics perturbed with seeded
numpy noise and carried to the port by ``novel_flax_to_state_dict``. It
reads the JAX package's 24×24 two-view sphere in the NOVEL_PE schema with
the mesh offsets replaced by non-zero seeded noise (the schema's zero
offsets would hide a wrong nearest vertex). The renderer's noise and the
step's pixels are what JAX draws from the same keys. Tolerances, all f32:
kNN indices exact (the plain version computes JAX's expression,
|v|² − 2·p·v, rounded the same way); deformed points and samples 1e-5;
field, renders and losses 1e-4 absolute / 1e-5 relative (convolutions and
matmuls summed in another order); each gradient within 1e-4 of its norm;
BN statistics 1e-4; Adam's first update (−lr·g / (|g| + ε)) 1e-2 of lr
on the components whose JAX gradient is at least 1e-3 of the largest
(their sign is what the update reads).
"""

import copy
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import yaml

from chip_smoke import knn_edge_cases
from diner_tpu.data.synthetic_dataset import SphereDataset as JSphereDataset
from diner_tpu.geometry import gen_rays as j_gen_rays
from diner_tpu.losses import init_vgg19_params
from diner_tpu.models.novel.model import NovelPixelNeRF as JNovel
from diner_tpu.models.novel.model import NovelPixelNeRFConfig as JNovelCfg
from diner_tpu.models.novel.model import make_gen_context as j_gen_context
from diner_tpu.models.novel.regressor import (
    DenseRegressorConfig as JRegCfg,
    create_regressor_state as j_create_regressor_state,
    make_regressor_train_step as j_regressor_step,
)
from diner_tpu.models.novel.renderer import render_rays_novel as j_render
from diner_tpu.models.novel.train import NovelConfig as JNovelConfig
from diner_tpu.models.novel.train import compute_novel_losses as j_losses
from diner_tpu.nn.spatial_encoder import SpatialEncoderConfig as JEncCfg
from diner_tpu.ops import knn as jknn
from diner_tpu.ops import sampling as jsamp
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train.diner import select_pixels as j_select_pixels
from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from diner_tpu_torch.losses import VGG19Features
from diner_tpu_torch.models.novel.model import (NovelPixelNeRF,
                                                NovelPixelNeRFConfig,
                                                make_gen_context)
from diner_tpu_torch.models.novel.regressor import (DenseRegressor,
                                                    DenseRegressorConfig,
                                                    RegressorTrainStep,
                                                    create_regressor_state)
from diner_tpu_torch.models.novel.renderer import render_rays_novel
from diner_tpu_torch.models.novel.train import (NovelConfig,
                                                build_novel_run_config,
                                                create_novel_state)
from diner_tpu_torch.models.scene import index_latent
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.ops import gather_cuda, knn_cuda
from diner_tpu_torch.ops import sampling as tsamp
from diner_tpu_torch.ops.knn import deform_points, knn1
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train.__main__ import main as train_main
from diner_tpu_torch.train.config import load_train_config
from diner_tpu_torch.utils.convert import (flax_to_state_dict,
                                           novel_flax_to_state_dict,
                                           regressor_flax_to_state_dict)
from test_torch_render import _perturbed, jax_noise

ROOT = Path(__file__).resolve().parents[1]
H = W = 24
ENC = dict(backbone="resnet18", num_layers=2, image_padding=8, padding_pe=4)
MODEL = dict(d_hidden=32, gen_latent_hw=16, gen_latent_ch=128)
RENDER = dict(n_samples=8, n_depth_candidates=32, n_gaussian=2,
              white_bkgd=True)
SRC = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
       "src_intrinsics")
MESH = ("target_vertices", "offset_target_to_source", "offset_target_to_gen")
N_VERTICES = 300


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _grad_close(g, jg, name, tol=1e-4):
    assert np.isfinite(g).all(), name
    np.testing.assert_allclose(g, jg, atol=tol * np.linalg.norm(jg) + 1e-9,
                               rtol=0, err_msg=name)


# ---------------------------------------------------------------- the kNN

def _cloud(seed, SB=2, N=500, V=137):
    rng = np.random.RandomState(seed)
    return (rng.randn(SB, N, 3).astype(np.float32),
            rng.randn(SB, V, 3).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 64, 499, 2048])
def test_knn1_matches_jax_exactly(chunk):
    pts, verts = _cloud(0)
    ref = np.asarray(jknn.knn1(jnp.asarray(pts), jnp.asarray(verts),
                               chunk=64))
    got = knn1(_t(pts), _t(verts), chunk=chunk)
    assert got.dtype == torch.int32 and got.shape == (2, 500)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the brute-force nearest vertex
    d = ((pts[:, :, None] - verts[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), d.argmin(-1))


def test_knn1_ties_go_to_the_lower_index():
    # duplicate vertices, and two vertices at the same distance
    verts = np.array([[[3.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0],
                       [0, 0, 5]]], np.float32)
    pts = np.array([[[0.0, 0, 0], [2, 0, 0], [0.5, 0.5, 0], [0, 0, 5]]],
                   np.float32)
    got = knn1(_t(pts), _t(verts), chunk=3).numpy()
    ref = np.asarray(jknn.knn1(jnp.asarray(pts), jnp.asarray(verts)))
    # (0,0,0): vertices 1, 2, 3 tie at d² = 1 → 1; (2,0,0): 0, 1, 3 tie → 0
    np.testing.assert_array_equal(got, [[1, 0, 1, 4]])
    np.testing.assert_array_equal(got, ref)
    # one vertex; scenes with different vertex sets
    one = knn1(_t(pts), _t(verts[:, :1])).numpy()
    assert (one == 0).all()
    p2, v2 = _cloud(3, SB=2, N=40, V=9)
    v2[1] += 10.0
    np.testing.assert_array_equal(
        knn1(_t(p2), _t(v2)).numpy(),
        np.asarray(jknn.knn1(jnp.asarray(p2), jnp.asarray(v2))))


def test_knn1_nan_follows_argmin():
    # a NaN distance wins over every number, the first NaN over later ones,
    # as JAX's argmin does; a point with a NaN coordinate gets index 0
    pts, verts = _cloud(4, SB=1, N=50, V=20)
    verts[0, 5, 1] = verts[0, 9, 0] = np.nan
    pts[0, 7, 2] = np.nan
    expected = np.full((1, 50), 5)
    expected[0, 7] = 0
    ref = np.asarray(jknn.knn1(jnp.asarray(pts), jnp.asarray(verts),
                               chunk=16))
    np.testing.assert_array_equal(ref, expected)
    for chunk in (3, 2048):
        np.testing.assert_array_equal(
            knn1(_t(pts), _t(verts), chunk=chunk).numpy(), expected)
    # the non-finite cases the kernel is held to on the card, against JAX
    for case in ("nan_inputs", "nonfinite_tiles"):
        p, v, want = knn_edge_cases("cpu")[case]
        assert torch.equal(knn1(p, v), want), case
        np.testing.assert_array_equal(
            np.asarray(jknn.knn1(jnp.asarray(p.numpy()),
                                 jnp.asarray(v.numpy()))), want.numpy(),
            err_msg=case)


def test_knn1_refuses_bad_shapes_and_cpu_kernel():
    pts, verts = _cloud(1, SB=1, N=4, V=3)
    with pytest.raises(ValueError, match=r"\(SB, N, 3\)"):
        knn1(_t(pts[..., :2]), _t(verts))
    with pytest.raises(ValueError, match="no vertices"):
        knn1(_t(pts), _t(verts[:, :0]))
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.knn1_kernel(_t(pts), _t(verts))
    before = knn_cuda.launches
    knn1(_t(pts), _t(verts))
    assert knn_cuda.launches == before  # the CPU runs the plain version


def test_deform_points_matches_jax():
    rng = np.random.RandomState(1)
    pts = rng.randn(2, 64, 3).astype(np.float32)
    verts = rng.randn(2, 40, 3).astype(np.float32)
    offs = (rng.randn(2, 40, 3) * 0.1).astype(np.float32)
    ref = np.asarray(jknn.deform_points(jnp.asarray(pts), jnp.asarray(verts),
                                        jnp.asarray(offs), chunk=32))
    before = gather_cuda.launches
    p = _t(pts).requires_grad_()
    got = deform_points(p, _t(verts), _t(offs), chunk=16)
    assert gather_cuda.launches == before  # the plain gather on the CPU
    _close(got.detach(), ref, 1e-6)
    assert not np.allclose(ref, pts)
    got.sum().backward()  # the points' gradient passes through unchanged
    assert torch.equal(p.grad, torch.ones_like(p))


# ------------------------------------------------------- deformed samplers

@pytest.fixture(scope="module")
def sampler_scene():
    """The NOVEL sphere's view maps, rays and mesh with non-zero offsets."""
    from diner_tpu.geometry.normals import depth_to_normal
    s = JSphereDataset("train", n=2, H=32, W=40, nv=2, model="NOVEL",
                       n_vertices=N_VERTICES)[0]
    rng = np.random.default_rng(4)
    verts = s["target_vertices"][None]
    off = (rng.normal(0, 0.02, verts.shape)).astype(np.float32)
    rays = np.asarray(j_gen_rays(
        jnp.asarray(s["target_extrinsics"][None]),
        jnp.asarray(s["target_intrinsics"][None]), 40, 32,
        jnp.full((1,), 0.8), jnp.full((1,), 2.4))).reshape(1, -1, 8)
    normals = np.asarray(depth_to_normal(
        jnp.asarray(s["src_depths"][..., 0]),
        jnp.asarray(s["src_intrinsics"])))[None]
    intr = s["src_intrinsics"][None]
    maps = dict(depths=s["src_depths"][None],
                depth_stds=s["src_depth_stds"][None], normals=normals,
                poses=s["src_extrinsics"][None],
                focal=np.stack([intr[..., 0, 0], intr[..., 1, 1]], -1),
                c=intr[..., :2, 2], image_wh=np.array([40, 32], np.float32))
    return rays[:, ::3].copy(), maps, verts, off


def _views(maps):
    return (tsamp.ViewMaps(**{k: _t(v) for k, v in maps.items()}),
            jsamp.ViewMaps(**{k: jnp.asarray(v) for k, v in maps.items()}))


@pytest.mark.parametrize("pruned", [False, True])
def test_samplers_with_deformation_match_jax(sampler_scene, pruned):
    rays, maps, verts, off = sampler_scene
    tv, jv = _views(maps)
    NR = rays.shape[1]
    rng = np.random.default_rng(9)
    u = rng.uniform(0, 1, (1, NR, 64)).astype(np.float32)
    g = rng.normal(0, 1, (1, NR, 3)).astype(np.float32)

    def t_def(x):
        return deform_points(x, _t(verts), _t(off))

    def j_def(x):
        return jknn.deform_points(x, jnp.asarray(verts), jnp.asarray(off))

    if pruned:
        def run(mod, arr, views, deform):
            return mod.sample_depthguided_pruned(
                arr(rays), views, 8, 64, 16, 4, arr(u), arr(g), 3,
                deform_fn=deform)
    else:
        def run(mod, arr, views, deform):
            return mod.sample_depthguided(arr(rays), views, 8, 64, arr(u),
                                          arr(g), 3, deform_fn=deform)
    z = run(tsamp, _t, tv, t_def)
    jz = np.asarray(run(jsamp, jnp.asarray, jv, j_def))
    np.testing.assert_array_equal(z.numpy() == 0, jz == 0)
    assert (z.numpy() != 0).any()
    _close(z, jz, 1e-5)
    # the deformation moves the shortlist, and the identity leaves the
    # undeformed sampler bit for bit as it was
    plain = run(tsamp, _t, tv, None)
    assert not torch.equal(plain, z)
    assert torch.equal(run(tsamp, _t, tv, lambda x: x), plain)


# ---------------------------------------------------- the model and field

def _novel_batch(use_pe, seed=0):
    """The JAX sphere's NOVEL(_PE) sample as a batch of one, textured
    sources, non-zero offsets."""
    s = JSphereDataset("train", n=4, H=H, W=W, nv=2,
                       model="NOVEL_PE" if use_pe else "NOVEL",
                       n_vertices=N_VERTICES)[1]
    b = {k: np.asarray(v)[None] for k, v in s.items()
         if isinstance(v, np.ndarray)}
    rng = np.random.default_rng(seed)
    b["src_rgbs"] = np.clip(b["src_rgbs"] + rng.normal(
        0, 0.1, b["src_rgbs"].shape), 0, 1).astype(np.float32)
    for k in MESH[1:]:
        b[k] = rng.normal(0, 0.02, b[k].shape).astype(np.float32)
    b["znear"] = np.full((1,), 0.8, np.float32)
    b["zfar"] = np.full((1,), 2.4, np.float32)
    return b


def _j_gen(b, use_pe):
    return j_gen_context(
        jnp.asarray(b["gen_extrinsics"]), jnp.asarray(b["gen_intrinsics"]),
        (W, H),
        src_pe_maps=jnp.asarray(b["src_pos_encodings"]) if use_pe else None,
        tgt_pe_map=(jnp.asarray(b["target_pos_encoding"])[:, None]
                    if use_pe else None))


def _t_gen(b, use_pe):
    return make_gen_context(
        _t(b["gen_extrinsics"]), _t(b["gen_intrinsics"]), (W, H),
        src_pe_maps=_t(b["src_pos_encodings"]) if use_pe else None,
        tgt_pe_map=_t(b["target_pos_encoding"])[:, None] if use_pe else None)


def _novel_pair(use_pe, seed=0):
    b = _novel_batch(use_pe, seed)
    jm = JNovel(cfg=JNovelCfg(encoder=JEncCfg(**ENC), use_pe_maps=use_pe,
                              **MODEL))
    z = jnp.zeros((1, 8, 3))
    variables = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), *(jnp.asarray(b[k]) for k in SRC),
        _j_gen(b, use_pe), z, z, z)
    variables = _perturbed(variables, seed + 100)
    tm = NovelPixelNeRF(NovelPixelNeRFConfig(
        encoder=SpatialEncoderConfig(**ENC), use_pe_maps=use_pe, **MODEL))
    tm.load_state_dict(novel_flax_to_state_dict(variables))  # strict
    return types.SimpleNamespace(b=b, jm=jm, variables=variables, tm=tm,
                                 use_pe=use_pe)


@pytest.fixture(scope="module", params=[False, True], ids=["NOVEL",
                                                           "NOVEL_PE"])
def pair(request):
    return _novel_pair(request.param)


def _encode_both(p):
    jctx, _ = jax.jit(lambda v, *src: p.jm.apply(
        v, *src, train=True, method="encode", mutable=["batch_stats"]))(
            p.variables, *(jnp.asarray(p.b[k]) for k in SRC))
    with torch.no_grad():
        tctx = p.tm.encode(*(_t(p.b[k]) for k in SRC))
    return jctx, tctx


def _rays(b):
    return np.asarray(j_gen_rays(
        jnp.asarray(b["target_extrinsics"]),
        jnp.asarray(b["target_intrinsics"]), W, H, jnp.asarray(b["znear"]),
        jnp.asarray(b["zfar"]))).reshape(1, H * W, 8)


def test_converter_covers_the_model(pair):
    sd = novel_flax_to_state_dict(pair.variables)
    assert sorted(sd) == sorted(pair.tm.state_dict())
    assert sd["gen_latent"].shape == (16, 16, 128)
    assert ("deformation_layer.weight" in sd) == pair.use_pe
    if pair.use_pe:
        assert sd["deformation_layer.weight"].shape == (128, 134)
    with pytest.raises(KeyError, match="gen_latent"):
        flax_to_state_dict(pair.variables)  # the plain bridge refuses it


def test_field_matches_jax(pair):
    jctx, tctx = _encode_both(pair)
    rays = _rays(pair.b)[:, ::7]
    t = np.linspace(0.1, 0.9, 6, dtype=np.float32)[:, None]
    xyz = (rays[:, :, None, :3] + (rays[:, :, None, 6:7] * (1 - t)
           + rays[:, :, None, 7:8] * t) * rays[:, :, None, 3:6]
           ).reshape(1, -1, 3).astype(np.float32)
    rng = np.random.default_rng(3)
    gxyz = (xyz + rng.normal(0, 0.05, xyz.shape)).astype(np.float32)
    dirs = np.broadcast_to(rays[:, :, None, 3:6], (1, rays.shape[1], 6, 3)
                           ).reshape(1, -1, 3).copy()
    ref = pair.jm.apply(pair.variables, jctx, _j_gen(pair.b, pair.use_pe),
                        jnp.asarray(xyz), jnp.asarray(gxyz),
                        jnp.asarray(dirs), method="field")
    gen = _t_gen(pair.b, pair.use_pe)
    with torch.no_grad():
        out = pair.tm.field(tctx, gen, _t(xyz), _t(gxyz), _t(dirs))
        # the CNN latent's pair table changes nothing, and the PE lookup
        # still reads the PE maps, not the table
        paired = tctx.with_latent_pairs()
        assert paired.latent_pairs is not None
        assert torch.equal(pair.tm.field(paired, gen, _t(xyz), _t(gxyz),
                                         _t(dirs)), out)
    assert out.shape == (1, xyz.shape[1], 4)
    assert float(out[..., 3].max()) > 0
    _close(out, ref)
    if pair.use_pe:
        uv = torch.rand((1, 2, 50, 2), generator=torch.Generator()
                        .manual_seed(0)) * 2 - 1
        pe = dataclasses.replace(paired, latent=gen.src_pe_maps,
                                 latent_pairs=None)
        bare = dataclasses.replace(tctx, latent=gen.src_pe_maps)
        got = index_latent(pe, uv)
        assert got.shape == (1, 2, 50, 3)
        assert torch.equal(got, index_latent(bare, uv))


def test_field_bf16_matches_jax(pair):
    """bf16 compute: the f32 plane plus the bf16 latent promotes to f32 in
    both packages before the MLP casts it back. bf16 convolutions and
    matmuls round at other places in the two frameworks, so the port's
    bf16 field is held to no further from JAX's f32 field than twice JAX's
    own bf16 field (in norm), as ``tests/test_torch_mvs_bf16.py`` holds
    TransMVSNet."""
    jm16 = JNovel(cfg=dataclasses.replace(pair.jm.cfg,
                                          compute_dtype="bfloat16"))
    tm = NovelPixelNeRF(dataclasses.replace(pair.tm.cfg,
                                            compute_dtype="bfloat16"))
    tm.load_state_dict(pair.tm.state_dict())
    rays = _rays(pair.b)[:, ::11]
    xyz = (rays[:, :, :3] + 1.6 * rays[:, :, 3:6]).astype(np.float32)
    dirs = rays[:, :, 3:6].copy()
    jgen = _j_gen(pair.b, pair.use_pe)

    def j_field(jm):
        ctx, _ = jax.jit(lambda v, *src: jm.apply(
            v, *src, train=True, method="encode", mutable=["batch_stats"]))(
                pair.variables, *(jnp.asarray(pair.b[k]) for k in SRC))
        return np.asarray(jm.apply(pair.variables, ctx, jgen,
                                   jnp.asarray(xyz), jnp.asarray(xyz + 0.01),
                                   jnp.asarray(dirs), method="field"))

    ref32, ref16 = j_field(pair.jm), j_field(jm16)
    with torch.no_grad():
        ctx = tm.encode(*(_t(pair.b[k]) for k in SRC))
        assert ctx.latent.dtype == torch.bfloat16
        out = tm.field(ctx, _t_gen(pair.b, pair.use_pe), _t(xyz),
                       _t(xyz + 0.01), _t(dirs)).numpy()
    assert out.dtype == np.float32
    jax_err = np.linalg.norm(ref16 - ref32)
    assert 0 < jax_err < 0.05 * np.linalg.norm(ref32)
    assert np.linalg.norm(out - ref32) <= 2 * jax_err


# ------------------------------------------------------------ the renderer

def test_render_rays_novel_matches_jax(pair):
    jctx, tctx = _encode_both(pair)
    rays = _rays(pair.b)[:, ::9].copy()
    NR = rays.shape[1]
    jcfg = JRendererConfig(**RENDER)
    cfg = RendererConfig(**RENDER)
    key = jax.random.PRNGKey(1)
    noise = tuple(_t(a) for a in jax_noise(key, 1, NR, jcfg))
    mesh = [jnp.asarray(pair.b[k]) for k in MESH]
    jgen = _j_gen(pair.b, pair.use_pe)

    def j_loss(params):
        v = {**pair.variables, "params": params}

        def ff(c, g, xyz, gxyz, vd):
            return pair.jm.apply(v, c, g, xyz, gxyz, vd, method="field")

        o = j_render(ff, jctx, jgen, jnp.asarray(rays), *mesh, key, jcfg)
        return jnp.mean(o.rgb ** 2), o

    (j_val, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        pair.variables["params"])

    tm = copy.deepcopy(pair.tm)
    tctx = dataclasses.replace(tctx, latent=tctx.latent.detach())
    out = render_rays_novel(tm.field, tctx, _t_gen(pair.b, pair.use_pe),
                            _t(rays), *(_t(pair.b[k]) for k in MESH), cfg,
                            noise=noise, want_weights=True)
    val = torch.mean(out.rgb ** 2)
    val.backward()
    _close(out.rgb.detach(), j_out.rgb)
    _close(out.depth.detach(), j_out.depth)
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    g = tm.gen_latent.grad.numpy()
    jg = np.asarray(j_grads["gen_latent"])
    assert np.linalg.norm(jg) > 0
    _grad_close(g, jg, "gen_latent")


# ----------------------------------------------------------- the train step

@pytest.fixture(scope="module")
def vgg_params():
    return jax.tree_util.tree_map(np.asarray, init_vgg19_params(0))


def test_novel_train_step_matches_jax(pair, vgg_params):
    extra = dict(w_vgg=0.1, vgg_spatch=8, w_antibias=1.0,
                 antibias_downsampling=3)
    jcfg = JNovelConfig(nerf=pair.jm.cfg, renderer=JRendererConfig(**RENDER),
                        **extra)
    jb = {k: jnp.asarray(v) for k, v in pair.b.items()}
    key = jax.random.PRNGKey(17)

    def loss_fn(params):
        return j_losses(pair.jm, jcfg, params, pair.variables["batch_stats"],
                        vgg_params, jb, key)

    (j_total, aux), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(pair.variables["params"])
    tx = optax.adam(jcfg.lr)
    upd, _ = tx.update(j_grads, tx.init(pair.variables["params"]),
                       pair.variables["params"])
    k_pix, k_render = jax.random.split(key)
    pix = np.array(j_select_pixels(jcfg, jb, k_pix))
    noise = jax_noise(k_render, 1, jcfg.rays_per_step, jcfg.renderer)

    cfg = NovelConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**RENDER),
                      **extra)
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict({"params": vgg_params}))
    state = create_novel_state(cfg, device="cpu", vgg=vgg)
    state.model.load_state_dict(pair.tm.state_dict())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = state(pair.b, noise=noise, pix_idcs=pix)
    assert state.step == 1
    assert sorted(metrics) == sorted(aux["metrics"])
    for k, v in aux["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["total"]), float(j_total),
                               rtol=1e-5)

    ref = novel_flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    refu = novel_flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, upd)})
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(ref)
    for k, p in named.items():
        _grad_close(p.grad.numpy(), ref[k].numpy(), k)
        jg = ref[k].numpy()
        sel = np.abs(jg) >= 1e-3 * np.abs(jg).max()
        du = (p.detach() - before[k]).numpy()
        np.testing.assert_allclose(du[sel], refu[k].numpy()[sel],
                                   atol=1e-2 * cfg.lr, rtol=0, err_msg=k)
    assert float(np.abs(ref["gen_latent"].numpy()).max()) > 0
    stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, aux["batch_stats"])})
    new = state.model.state_dict()
    for k, v in stats.items():
        assert not torch.equal(new[k], before[k]), k
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


# -------------------------------------------------------- the regressor

def test_dense_regressor_matches_jax():
    rng = np.random.RandomState(3)
    jcfg = JRegCfg(backbone="resnet18", num_point=50, dim_output=2, lr=1e-3)
    # 64×64: at 32×32 the last stage is 1×1, its train-mode BN takes the
    # variance of 2 values, and flax's E[x²] − E[x]² loses 1e-2 there
    imgs = rng.rand(2, 64, 64, 3).astype(np.float32)
    kpts = rng.rand(2, 50, 2).astype(np.float32)
    jm, jstate, tx = j_create_regressor_state(jcfg, jax.random.PRNGKey(0),
                                              jnp.asarray(imgs))
    variables = {"params": jstate["params"],
                 "batch_stats": jstate["batch_stats"]}
    cfg = DenseRegressorConfig(backbone="resnet18", num_point=50,
                               dim_output=2, lr=1e-3)
    state = create_regressor_state(cfg, device="cpu")
    sd = regressor_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables))
    assert sorted(sd) == sorted(state.model.state_dict())
    state.model.load_state_dict(sd)
    with torch.no_grad():
        out = state.model(_t(imgs), train=False)
    ref = jm.apply(variables, jnp.asarray(imgs), train=False)
    assert out.shape == (2, 50, 2)
    _close(out, ref)

    jnext, jm_metrics = jax.jit(j_regressor_step(jm, tx))(
        jstate, {"image": jnp.asarray(imgs),
                 "target_keypoints": jnp.asarray(kpts)})
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = state({"image": imgs, "target_keypoints": kpts})
    np.testing.assert_allclose(float(m["total"]), float(jm_metrics["total"]),
                               rtol=1e-5)
    after = regressor_flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jnext["params"],
                     "batch_stats": jnext["batch_stats"]}))
    grads = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    for k, v in state.model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), after[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
            continue
        g = grads[k]
        sel = np.abs(g) >= 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(
            (v - before[k]).numpy()[sel],
            (after[k] - before[k]).numpy()[sel], atol=1e-2 * cfg.lr,
            rtol=0, err_msg=k)
    assert isinstance(state, RegressorTrainStep)
    assert isinstance(state.model, DenseRegressor) and state.step == 1


# ----------------------------------------------------------- the dataset

@pytest.mark.parametrize("model", ["NOVEL", "NOVEL_PE"])
@pytest.mark.parametrize("stage", ["train", "val"])
def test_sphere_novel_schemas_match_jax(model, stage):
    kw = dict(stage=stage, n=3, H=20, W=24, nv=2, model=model,
              n_vertices=77)
    ours, ref = SphereDataset(**kw), JSphereDataset(**kw)
    for i in (0, 2):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                assert a[k].dtype == v.dtype, k
                np.testing.assert_array_equal(a[k], v, err_msg=k)
            else:
                assert a[k] == v, k
    assert ours[0]["target_vertices"].shape == (77, 3)
    assert ("src_pos_encodings" in ours[0]) == (model == "NOVEL_PE")


# ------------------------------------------------------------------ the CLI

def _novel_cfg(tmp_path):
    """configs/train_novel_facescape.yaml on the sphere, cut to CPU size
    (resnet18: its 4 levels give the 512 channels of the default plane)."""
    raw = yaml.safe_load(
        (ROOT / "configs/train_novel_facescape.yaml").read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    sphere = {"module": "synthetic_sphere",
              "kwargs": {"n": 2, "H": 24, "W": 24, "nv": 2,
                         "n_vertices": 64}}
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"] = sphere
    enc = raw["nerf"]["kwargs"]["encoder_conf"]["kwargs"]
    enc.update({"backbone": "resnet18", "image_padding": 8})
    raw["nerf"]["kwargs"]["mlp_fine_conf"]["kwargs"]["d_hidden"] = 32
    raw["renderer"]["kwargs"].update(
        {"n_samples": 8, "n_depth_candidates": 32, "n_gaussian": 2})
    raw["optimizer"]["kwargs"]["vgg_spatch"] = 8
    p = tmp_path / "novel.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p


@pytest.mark.parametrize("model", ["NOVEL", "NOVEL_PE"])
def test_novel_cli_trains_on_the_cpu(tmp_path, monkeypatch, model):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    p = _novel_cfg(tmp_path)
    train_main([str(p), model, "--device", "cpu", "--max-steps", "2",
                "--num-workers", "0"])
    ckpt = tmp_path / "out" / "NOVEL" / "checkpoints" / "step_00000002"
    state = ckpt_lib.load_state(ckpt)
    assert state["step"] == 2
    assert state["model"]["gen_latent"].shape == (192, 192, 512)
    assert ("deformation_layer.weight" in state["model"]) == (
        model == "NOVEL_PE")
    assert all(torch.isfinite(v).all() for v in state["model"].values())
    # the NOVEL train state restores from it bit for bit
    run_cfg = load_train_config(p, model_name=model)
    fresh = create_novel_state(build_novel_run_config(
        run_cfg, model == "NOVEL_PE"), seed=1, device="cpu",
        vgg=VGG19Features())
    ckpt_lib.restore_checkpoint(ckpt, fresh)
    assert fresh.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, state["model"][k]), k
    assert fresh.optimizer.state_dict()["state"][0]["step"] == 2
    with pytest.raises(SystemExit) as e:
        train_main([str(p), "IBRNet", "--device", "cpu"])
    assert e.value.code == 2
