"""The plans of the port's redesigned kernels, emulated on the CPU.

The top-1 kNN (``csrc/knn1.cu``) skips vertex tiles by a bound, and the
DCN sampler's backward (``csrc/dcn_sample_bwd.cu``) splits a tap's corners
between the tiles that own them and a spill pass. Neither kernel runs
here, so each plan is emulated in plain PyTorch, step by step as the kernel
takes it, and held to the plain version:

- the kNN: the same Morton order, tiles, boxes, representatives, margin,
  warp vote (32 consecutive points) and tie rule (d², original index) give
  exactly ``knn1_plain``'s indices on ray-ordered points through the sphere
  fixture, on uniform points in a cube, on ``chip_smoke.knn_edge_cases``
  and on points equidistant from mirrored vertices in different tiles;
- the DCN backward: each tile's canvas from the corners of its ring-grown
  region that fall in it, plus the spilled corners, gives the four outputs
  of ``bilinear_sample_pix_bwd_plain`` within 1e-5 of each output's max, at
  odd H and W, in f32 and bf16, with offsets that spill and with every
  point spilled.

The kernels themselves are held to the same cases on the card by
``tests/test_torch_kernels.py -m cuda`` and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

from chip_smoke import knn_edge_cases, knn_ray_points
from diner_tpu_torch.ops import cuda_build, dcn_cuda, knn_cuda

KNN_SRC = (cuda_build.PKG_DIR / cuda_build.SOURCES["knn1"]).read_text()
DCN_SRC = (cuda_build.PKG_DIR
           / cuda_build.SOURCES["dcn_sample_bwd"]).read_text()


def _constant(src, name):
    m = re.search(rf"constexpr (?:int|float) {name} = ([^;]+);", src)
    text = m.group(1).rstrip("f")
    return float.fromhex(text) if "0x" in text else float(text)


MARGIN_SCALE = _constant(KNN_SRC, "kMarginScale")
MARGIN_FLOOR = _constant(KNN_SRC, "kMarginFloor")
SAFE_PRODUCT = _constant(KNN_SRC, "kSafeProduct")
WARP = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_kernel_constants_match_the_wrappers():
    assert _constant(DCN_SRC, "kTileH") == dcn_cuda.TILE_H
    assert _constant(DCN_SRC, "kTileW") == dcn_cuda.TILE_W
    assert _constant(DCN_SRC, "kRing") == dcn_cuda.RING
    assert _constant(DCN_SRC, "kMaxTileC") == dcn_cuda.MAX_TILE_C
    assert MARGIN_SCALE == 2.0 ** -18
    assert dcn_cuda.tiled((4, 512, 640, 32), 512 * 640)
    assert not dcn_cuda.tiled((2, 7, 9, 32), 1001)
    assert not dcn_cuda.tiled((1, 8, 8, 48), 64)


# ------------------------------------------------------------------ kNN

def _dist2(px, py, pz, rows):
    """(SB, N) coordinates, (SB, n, 4) rows → (SB, N, n) d², rounded as
    the kernel rounds it (fmaf(−2, dot, |v|²) is one rounding of an exact
    product, as here)."""
    vx, vy, vz, sq = (rows[..., k][:, None, :] for k in range(4))
    dot = px[..., None] * vx + py[..., None] * vy
    dot = dot + pz[..., None] * vz
    return (-2.0 * dot) + sq


def knn1_cull_emulation(points, vertices):
    """The kernel's plan step by step: (indices, share of (warp, tile)
    pairs culled)."""
    plan = knn_cuda.tile_plan(vertices)
    SB, N, _ = points.shape
    V = vertices.shape[1]
    tile = knn_cuda.TILE
    T = -(-V // tile)
    warps = -(-N // WARP)
    pad = warps * WARP - N
    p = torch.nn.functional.pad(points.float(), (0, 0, 0, pad))
    active = torch.arange(warps * WARP) < N
    px, py, pz = p.unbind(-1)
    p_max = p.abs().amax(-1)
    p1 = (px.abs() + py.abs()) + pz.abs()
    inf = torch.tensor(float("inf"))
    ub = _dist2(px, py, pz, plan["reps"])
    ub = torch.where(torch.isnan(ub), inf, ub).amin(-1)
    best = torch.full(p_max.shape, float("inf"))
    best_i = torch.full(p_max.shape, 2 ** 31 - 1, dtype=torch.int64)
    scanned = 0
    for t in range(T):
        b = plan["boxes"][:, t][:, None, :]  # (SB, 1, 8)
        safe = p_max * b[..., 7] < SAFE_PRODUCT
        c = [torch.minimum(torch.maximum(q, b[..., k]), b[..., k + 3])
             for k, q in enumerate((px, py, pz))]
        lb = ((c[0] * (c[0] - 2 * px) + c[1] * (c[1] - 2 * py))
              + c[2] * (c[2] - 2 * pz))
        margin = MARGIN_SCALE * (b[..., 6] * (2 * p1 + b[..., 6])) \
            + MARGIN_FLOOR
        skip = ~active | (safe & (lb - margin > torch.fmin(ub, best)))
        go = ~skip.reshape(SB, warps, WARP).all(-1)  # the warp vote
        scanned += int(go.sum())
        go = go.repeat_interleave(WARP, dim=1)
        t0 = t * tile
        d2 = _dist2(px, py, pz, plan["verts"][:, t0:t0 + tile])
        nan = torch.isnan(d2)
        fast = torch.where(nan, inf, d2)  # strict <: NaN is never taken
        tb = fast.amin(-1)
        tj = (fast == tb[..., None]).int().argmax(-1)
        first_nan = nan.int().argmax(-1)
        has_nan = ~safe & nan.any(-1)  # the NaN-aware scan
        tb = torch.where(has_nan, torch.nan, tb)
        tj = torch.where(has_nan, first_nan, tj)
        ti = plan["vidx"][:, t0:t0 + tile].long().gather(1, tj)
        take = torch.where(
            torch.isnan(tb), ~torch.isnan(best) | (ti < best_i),
            (tb < best) | ((tb == best) & (ti < best_i)))
        take &= go
        best = torch.where(take, tb, best)
        best_i = torch.where(take, ti, best_i)
    culled = 1.0 - scanned / max(SB * warps * T, 1)
    return best_i[:, :N].int(), culled


def _sphere(V, seed=0):
    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    return torch.from_numpy(SphereDataset._surface_points(V, seed))[None]


def test_knn_tile_plan_layout():
    v = torch.randn(2, 1000, 3, generator=torch.Generator().manual_seed(1))
    v[0, 5, 1] = float("nan")
    v[1, 7] = float("inf")
    plan = knn_cuda.tile_plan(v)
    tile = knn_cuda.TILE
    for s in range(2):
        perm = plan["vidx"][s].long()
        assert sorted(perm.tolist()) == list(range(1000))
        for t0 in range(0, 1000, tile):  # each tile in index order
            seg = perm[t0:t0 + tile]
            assert bool((seg[1:] > seg[:-1]).all())
        torch.testing.assert_close(plan["verts"][s, :, :3], v[s, perm],
                                   rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(plan["boxes"][0, -1, 7])  # the NaN vertex's tile
    assert torch.isinf(plan["boxes"][1, -1, 7])
    assert torch.isfinite(plan["boxes"][:, :-1]).all()
    assert 5 in plan["vidx"][0, -tile:] and 7 in plan["vidx"][1, -tile:]
    box = plan["boxes"][1, 0]
    first = plan["verts"][1, :tile, :3]
    assert bool((first >= box[:3]).all() and (first <= box[3:6]).all())
    assert plan["reps"].shape == (2, -(-1000 // knn_cuda.REP_STRIDE), 4)


def test_knn_cull_emulation_on_ray_ordered_points():
    points, verts = knn_ray_points("cpu", n_rays=48, n_cand=128, V=3000)
    got, culled = knn1_cull_emulation(points, verts)
    assert torch.equal(got, knn_cuda.knn1_plain(points, verts))
    assert culled > 0.5, culled


def test_knn_cull_emulation_on_uniform_points():
    verts = _sphere(3000)
    g = torch.Generator().manual_seed(3)
    points = torch.rand((1, 4000, 3), generator=g) * 1.2 - 0.6
    got, culled = knn1_cull_emulation(points, verts)
    assert torch.equal(got, knn_cuda.knn1_plain(points, verts))
    assert 0.0 <= culled < 1.0


@pytest.mark.parametrize("case", sorted(knn_edge_cases("cpu")))
def test_knn_cull_emulation_on_the_edge_cases(case):
    points, verts, expected = knn_edge_cases("cpu")[case]
    got, _ = knn1_cull_emulation(points, verts)
    assert torch.equal(got, knn_cuda.knn1_plain(points, verts))
    if expected is not None:
        assert torch.equal(got, expected)


def test_knn_cull_emulation_on_ties_across_tiles():
    """``mirror_ties``: vertex i and i + 600 mirrored across y = 0, in
    other tiles; every point at y = 0 ties between a pair, and the lower
    index must win whichever tile comes first."""
    points, verts, _ = knn_edge_cases("cpu")["mirror_ties"]
    half = verts.shape[1] // 2
    plan = knn_cuda.tile_plan(verts)
    tile_of = torch.empty(verts.shape[1], dtype=torch.int64)
    tile_of[plan["vidx"][0].long()] = (
        torch.arange(verts.shape[1]) // knn_cuda.TILE)
    got, _ = knn1_cull_emulation(points, verts)
    assert torch.equal(got, knn_cuda.knn1_plain(points, verts))
    got = got.long()
    assert bool((got < half).all())
    assert bool((tile_of[got] != tile_of[got + half]).all())
    # the mirror's tile comes first for some points
    assert bool((tile_of[got] > tile_of[got + half]).any())


# ------------------------------------------------------------ DCN backward

def dcn_tiled_emulation(img, x, y, scale, g):
    """The tap design's partition: each tile sums the corners in it of the
    points of its region (the tile grown by the ring, clipped to the
    image), writes its rows once, and the spilled corners are added after.
    → (d_img f32, d_x, d_y, d_scale)."""
    N, H, W, C = img.shape
    TH, TW, R = dcn_cuda.TILE_H, dcn_cuda.TILE_W, dcn_cuda.RING
    corners, (wx1, wy1) = dcn_cuda.corner_meta(img.shape, x, y, scale)
    g32 = g.float()
    pix = torch.arange(H * W)
    py, px = pix // W, pix % W
    acc = torch.full((N * H * W, C), float("nan"))
    for y0 in range(0, H, TH):
        for x0 in range(0, W, TW):
            th, tw = min(TH, H - y0), min(TW, W - x0)
            region = ((py >= y0 - R) & (py < y0 + th + R)
                      & (px >= x0 - R) & (px < x0 + tw + R))
            rows = (torch.arange(N)[:, None] * H * W
                    + ((y0 + torch.arange(th))[:, None] * W
                       + x0 + torch.arange(tw)).reshape(-1)).reshape(-1)
            tile = torch.zeros((N * H * W, C))
            for idx, w, valid, _ in corners:
                q = idx % (H * W)
                inside = (valid & region & (q // W >= y0) & (q // W < y0 + th)
                          & (q % W >= x0) & (q % W < x0 + tw))
                wq = w.to(img.dtype).float()
                tile.index_add_(0, idx[inside],
                                g32[inside] * wq[inside][:, None])
            assert torch.isnan(acc[rows]).all()  # each row written once
            acc[rows] = tile[rows]
    for (idx, w, _, _), spill in zip(
            corners, dcn_cuda.spilled_corners(img.shape, x, y)):
        wq = w.to(img.dtype).float()
        acc.index_add_(0, idx[spill], g32[spill] * wq[spill][:, None])
    flat = img.reshape(N * H * W, C)
    dw = [(g32 * flat[idx.reshape(-1)].reshape(g.shape).float()).sum(-1)
          for idx, _, _, _ in corners]
    return (acc.reshape(N, H, W, C),) + dcn_cuda._rest(corners, dw, wx1, wy1,
                                                       scale)


def dcn_tap_case(N, H, W, C, dtype, std, shift_y=0.0, seed=0):
    """A tap's inputs on the CPU: the pixel grid plus N(0, std) offsets
    (and ``shift_y`` rows), a sigmoid scale, g and the image from numpy."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    x = gx.reshape(1, -1) + std * rng.standard_normal((N, H * W))
    y = gy.reshape(1, -1) + shift_y + std * rng.standard_normal((N, H * W))
    scale = 1 / (1 + np.exp(-rng.standard_normal((N, H * W))))
    img = rng.standard_normal((N, H, W, C))
    g = rng.standard_normal((N, H * W, C))
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (f(img).to(dtype), f(x), f(y), f(scale), f(g).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [5, 32])
@pytest.mark.parametrize("spread", ["spills", "all_spill"])
def test_dcn_tile_partition_equals_the_plain_backward(dtype, C, spread):
    N, H, W = 2, 29, 37
    if spread == "spills":
        args = dcn_tap_case(N, H, W, C, dtype, std=4.0)
    else:  # 20 rows down: past every ring
        args = dcn_tap_case(N, H, W, C, dtype, std=0.3, shift_y=20.0)
    img, x, y, scale, g = args
    spills = dcn_cuda.spilled_corners(img.shape, x, y)
    valid = [c[2] for c in dcn_cuda.corner_meta(img.shape, x, y, None)[0]]
    n_spill = sum(int(s.sum()) for s in spills)
    n_valid = sum(int(v.sum()) for v in valid)
    if spread == "spills":
        assert 0 < n_spill < n_valid
    else:
        assert n_spill == n_valid > 0
    got = dcn_tiled_emulation(*args)
    ref = dcn_cuda.bilinear_sample_pix_bwd_plain(*args, f32_d_img=True)
    for a, b in zip(got, ref):
        err = (a - b).abs().max() / b.abs().max()
        assert err <= 1e-5, float(err)
