"""Port parity for the row gather (kernel C's plain version on the CPU) and
the wide-row pair-table latent lookup.

``row_gather`` is held against ``pallas_row_gather`` in interpret mode on
the cases of ``tests/test_pallas_gather.py`` and, for the row widths that
TPU kernel refuses (C = 1 and C = 5 f32), against JAX's ``flat[idx]``. A
gather copies bits, so every comparison is exact. The pair table and its
lookup are held against the JAX package exactly in f32 and bf16; the port's
pair-table ``index_latent`` equals its 4-corner one bit for bit and the
JAX package's pair-table lookup within 1e-6 (f32; the uv rescale is one
multiply in either package). The flat row gathers of a render are counted
per chunk on the CPU: they are the launches of kernel C on the card.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from diner_tpu.models.scene import SceneContext as JSceneContext
from diner_tpu.models.scene import index_latent as j_index_latent
from diner_tpu.ops import grid_sample as jgs
from diner_tpu.ops.pallas.gather_pallas import pallas_row_gather
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.models.scene import SceneContext, index_latent
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.ops import gather_cuda
from diner_tpu_torch.ops import grid_sample as tgs
from diner_tpu_torch.ops import sampling as tsamp
from diner_tpu_torch.renderer import RendererConfig, render_rays
from diner_tpu_torch.train.diner import DinerConfig, SRC_KEYS, target_rays
from test_torch_render import RENDER

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _table(rng, R, C, dtype):
    x = rng.standard_normal((R, C)).astype(np.float32)
    j = jnp.asarray(x, JDTYPES[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDTYPES[dtype])


def _same(t, j):
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(jnp.asarray(j, jnp.float32)))


# -------------------------------------------------------------- row gather

@pytest.mark.parametrize("dtype,C", [("float32", 128), ("float32", 256),
                                     ("bfloat16", 512)])
def test_row_gather_matches_pallas_row_gather(dtype, C):
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(0)
    j_table, t_table = _table(rng, 300, C, dtype)
    idx = rng.integers(0, 300, 2500).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_row_gather(j_table, jnp.asarray(idx), blk=1024, depth=8)
    before = gather_cuda.launches
    out = gather_cuda.row_gather(t_table, torch.from_numpy(idx))
    assert gather_cuda.launches == before  # the plain version on the CPU
    assert out.dtype == t_table.dtype and out.shape == (2500, C)
    _same(out, ref)


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_row_gather_narrow_rows_match_jax_take(C, index_dtype):
    # rows the TPU kernel refuses (test_pallas_gather.py): depth and maps
    rng = np.random.default_rng(C)
    j_table, t_table = _table(rng, 1000, C, "float32")
    idx = rng.integers(0, 1000, 4321).astype(index_dtype)
    _same(gather_cuda.row_gather(t_table, torch.from_numpy(idx)),
          j_table[jnp.asarray(idx)])


@pytest.mark.parametrize("R,P", [(300, 1), (1, 50), (300, 0)])
def test_row_gather_edge_sizes(R, P):
    rng = np.random.default_rng(R + P)
    j_table, t_table = _table(rng, R, 7, "bfloat16")
    idx = rng.integers(0, R, P)
    out = gather_cuda.row_gather(t_table, torch.from_numpy(idx))
    assert out.shape == (P, 7) and out.dtype == torch.bfloat16
    _same(out, j_table[jnp.asarray(idx, jnp.int32)])


def test_row_gather_backward_is_index_add():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((40, 6)).astype(
        np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 40, 300))
    g = torch.from_numpy(rng.standard_normal((300, 6)).astype(np.float32))
    gather_cuda.row_gather(table, idx).backward(g)
    j_grad = jax.grad(lambda t: jnp.sum(t[jnp.asarray(idx.numpy())]
                                        * jnp.asarray(g.numpy())))(
        jnp.asarray(table.detach().numpy()))
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(j_grad),
                               atol=1e-6, rtol=0)
    # a strided row view is taken as it is: no copy, the same values
    wide = torch.from_numpy(rng.standard_normal((40, 9)).astype(np.float32))
    view = wide[:, 2:7]
    np.testing.assert_array_equal(gather_cuda.row_gather(view, idx).numpy(),
                                  wide.numpy()[idx.numpy(), 2:7])


# -------------------------------------------------------------- pair table

def _img_uv(seed, dtype, N=3, H=6, W=8, C=5, P=37):
    rng = np.random.RandomState(seed)
    j_img = jnp.asarray(rng.randn(N, H, W, C), JDTYPES[dtype])
    uv = rng.uniform(-1.4, 1.4, (N, P, 2)).astype(np.float32)
    # exact-border and exact-integer coordinates, as the JAX package's test
    uv[:, 0] = [1.0, 1.0]
    uv[:, 1] = [-1.0, -1.0]
    uv[:, 2] = [(2 * 6.0 + 1) / W - 1, 0.25]
    t_img = torch.from_numpy(np.array(j_img.astype(jnp.float32))).to(
        TDTYPES[dtype])
    return j_img, t_img, uv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_table_matches_jax(dtype):
    j_img, t_img, uv = _img_uv(3, dtype)
    pairs = tgs.build_pair_table(t_img)
    j_pairs = jgs.build_pair_table(j_img)
    assert pairs.shape == j_pairs.shape == (3 * 6 * 8, 10)
    _same(pairs, j_pairs)
    out = tgs.grid_sample_bilinear_pairs(pairs, t_img.shape,
                                         torch.from_numpy(uv))
    assert out.dtype == t_img.dtype
    _same(out, jgs.grid_sample_bilinear_pairs(j_pairs, j_img.shape,
                                              jnp.asarray(uv)))
    # bit-identical to the 4-corner forward of the port
    ref = tgs.grid_sample_bilinear(t_img, torch.from_numpy(uv))
    np.testing.assert_array_equal(out.float().numpy(), ref.float().numpy())


def test_pair_table_rejects_odd_width_and_zeros_mode():
    with pytest.raises(ValueError, match="even W"):
        tgs.build_pair_table(torch.zeros(1, 4, 5, 2))
    t = tgs.build_pair_table(torch.zeros(1, 4, 6, 2))
    with pytest.raises(ValueError, match="border"):
        tgs.grid_sample_bilinear_pairs(t, (1, 4, 6, 2), torch.zeros(1, 3, 2),
                                       "zeros")


def _contexts(seed, Wl=8, pad=1):
    rng = np.random.default_rng(seed)
    SB, NV, Hl, C = 1, 2, 6, 16
    arrays = dict(
        latent=rng.standard_normal((SB, NV, Hl, Wl, C)).astype(np.float32),
        depths=np.ones((SB, NV, 4, 4, 1), np.float32),
        depth_stds=np.ones((SB, NV, 4, 4, 1), np.float32),
        normals=np.zeros((SB, NV, 4, 4, 3), np.float32),
        poses=np.tile(np.eye(4, dtype=np.float32), (SB, NV, 1, 1)),
        focal=np.ones((SB, NV, 2), np.float32),
        c=np.ones((SB, NV, 2), np.float32),
        image_wh=np.array([4.0, 4.0], np.float32))
    t = SceneContext(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                     feature_padding=pad)
    j = JSceneContext(**{k: jnp.asarray(v) for k, v in arrays.items()},
                      feature_padding=pad)
    uv = rng.uniform(-1.2, 1.2, (SB, NV, 200, 2)).astype(np.float32)
    return t, j, uv


def test_index_latent_through_pair_table():
    t, j, uv = _contexts(5)
    tp = t.with_latent_pairs()
    assert tp is not t and tp.latent_pairs.shape == (2 * 6 * 8, 32)
    assert tp.with_latent_pairs() is tp
    four = index_latent(t, torch.from_numpy(uv))
    pairs = index_latent(tp, torch.from_numpy(uv))
    np.testing.assert_array_equal(pairs.numpy(), four.numpy())
    j_pairs = j_index_latent(j.with_latent_pairs(), jnp.asarray(uv))
    np.testing.assert_allclose(pairs.numpy(), np.asarray(j_pairs), atol=1e-6,
                               rtol=0)
    # an odd latent width keeps the 4-corner lookup, as in JAX
    t_odd, _, _ = _contexts(6, Wl=7)
    assert t_odd.with_latent_pairs() is t_odd


# ------------------------------------------ row gathers of a render chunk

def _counting(monkeypatch):
    calls = []

    def spy(table, idx):
        calls.append(tuple(table.shape))
        return gather_cuda.row_gather(table, idx)

    monkeypatch.setattr(tgs, "row_gather", spy)
    monkeypatch.setattr(tsamp, "row_gather", spy)
    return calls


@pytest.mark.parametrize("case,expected", [
    ("one_stage", 6), ("pruned", 7), ("pairs", 4)])
def test_row_gathers_per_render_chunk(monkeypatch, case, expected):
    """A chunk's flat row gathers: the sampler's map (1, or 2 with the
    pruned sampler), the latent's 4 corners (or 2 pair rows) and the depth
    lookup. On the card each is one launch of kernel C."""
    torch.manual_seed(0)
    model = PixelNeRF(PixelNeRFConfig(encoder=SpatialEncoderConfig(
        backbone="resnet18", num_layers=2, image_padding=8), d_hidden=16))
    batch = {k: torch.from_numpy(v) for k, v in
             make_sphere_scene(H=16, W=20, nv=2).items()}
    cfg = RendererConfig(**RENDER, n_refine_bins=4,
                         n_coarse_candidates=16 if case == "pruned" else 0)
    with torch.no_grad():
        ctx = model.encode(*(batch[k] for k in SRC_KEYS))
        if case == "pairs":
            ctx = ctx.with_latent_pairs()
        rays = target_rays(DinerConfig(), batch, 16, 20)[:, :64].contiguous()
        calls = _counting(monkeypatch)
        render_rays(model.field, ctx, rays, cfg,
                    generator=torch.Generator().manual_seed(1))
    assert len(calls) == expected, calls
