"""The plans of the port's redesigned kernels, emulated on the CPU.

The top-1 kNN (``csrc/knn1.cu``) skips vertex tiles by a bound, the
DCN sampler's backward (``csrc/dcn_sample_bwd.cu``) splits a tap's corners
between the tiles that own them and a spill pass, and the mesh z-buffer
(``csrc/rasterize_depth.cu``, kernel R) bins faces to pixel tiles. None of
these kernels runs here, so each plan is emulated in plain PyTorch or
numpy, step by step as the kernel takes it, and held to the plain version:

- the kNN: the same Morton order, tiles, boxes, representatives, margin,
  warp vote (32 consecutive points) and tie rule (d², original index) give
  exactly ``knn1_plain``'s indices on ray-ordered points through the sphere
  fixture, on uniform points in a cube, on ``chip_smoke.knn_edge_cases``
  and on points equidistant from mirrored vertices in different tiles;
- the DCN backward: each tile's canvas from the corners of its ring-grown
  region that fall in it, plus the spilled corners, gives the four outputs
  of ``bilinear_sample_pix_bwd_plain`` within 1e-5 of each output's max, at
  odd H and W, in f32 and bf16, with offsets that spill and with every
  point spilled;
- kernel R: each face's tile range, from its grown box in f32 as the
  kernel computes it, holds every pixel centre the per-pixel box test
  admits (so every pair the plain version covers) or the face is on the
  large list, on ``chip_smoke.rasterize_edge_cases`` and on seeded meshes
  with boxes at ±1e4 and ±1e10; the lists never outgrow the capacity the
  wrapper allocates; a tile kernel reading only its list and the large
  faces, each warp only those that meet its rows, gives the plain map bit
  for bit; the tile kernel's early exit
  before the divisions drops no covered pair; and the plain version's
  row-band cull changes no map.

The kernels themselves are held to the same cases on the card by
``tests/test_torch_kernels.py -m cuda`` and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

from chip_smoke import (cube_head_mesh, head_mesh, knn_edge_cases,
                        knn_ray_points, raster_bin_plan,
                        rasterize_edge_cases)
from diner_tpu_torch.ops import cuda_build, dcn_cuda, knn_cuda
from diner_tpu_torch.ops import rasterize_cuda as rc

KNN_SRC = (cuda_build.PKG_DIR / cuda_build.SOURCES["knn1"]).read_text()
DCN_SRC = (cuda_build.PKG_DIR
           / cuda_build.SOURCES["dcn_sample_bwd"]).read_text()
RASTER_SRC = (cuda_build.PKG_DIR
              / cuda_build.SOURCES["rasterize_depth"]).read_text()


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


# ---------------------------------------------------------------- kernel R

def test_raster_constants_match_the_wrapper():
    assert _constant(RASTER_SRC, "kTile") == rc.TILE
    assert _constant(RASTER_SRC, "kSlice") == rc.SLICE
    assert _constant(RASTER_SRC, "kSpan") == rc.SPAN
    assert rc.SLICE % _constant(RASTER_SRC, "kChunk") == 0
    assert rc.LAUNCHES_PER_CALL == 4
    lay = rc.bin_layout(50400, 2048, 1334)
    assert (lay["gx"], lay["gy"], lay["tiles"]) == (84, 128, 10752)
    assert lay["capacity"] == rc.SPAN ** 2 * 50400
    assert lay["items"] == 10752 + -(-lay["capacity"] // rc.SLICE)
    assert lay["counts"] == 2 * lay["items"]
    assert lay["ints"] == (2 * lay["items"] + 4 * 10752 + 3 + 50400
                           + lay["capacity"])


def raster_plan(uv, z, faces, H, W):
    """``chip_smoke.raster_bin_plan``'s per-face arrays in numpy: the tile
    ranges x0, x1, y0, y1, and the flags hit, large, binned."""
    plan = raster_bin_plan(uv, z, faces, H, W)
    return plan, {k: plan[k].numpy() for k in
                  ("x0", "x1", "y0", "y1", "hit", "large", "binned")}


def raster_far_mesh(scale, seed):
    """Seeded triangles on a 45×70 map: a third with one vertex pushed to
    ±``scale`` px (in x or y), a sixth with two, a sixth entirely at
    ±``scale`` (off the map), the rest a few pixels wide."""
    rng = np.random.RandomState(seed)
    H, W, F = 45, 70, 150
    c = rng.uniform([0, 0], [W, H], (F, 2))
    uv = c[:, None] + rng.normal(size=(F, 3, 2)) * 6.0
    kind = rng.randint(0, 6, F)
    far = rng.choice([-1.0, 1.0], (F, 3, 2)) * scale \
        * rng.uniform(0.5, 1.0, (F, 3, 2))
    axis = rng.randint(0, 2, F)
    for i in range(F):
        n = {0: 1, 1: 1, 2: 2, 3: 3}.get(kind[i], 0)
        if n == 3:
            uv[i] = far[i]
        elif n:
            uv[i, :n, axis[i]] = far[i, :n, axis[i]]
    z = rng.uniform(0.5, 3.0, (F, 3))
    return (torch.from_numpy(uv.reshape(-1, 2).astype(np.float32)),
            torch.from_numpy(z.ravel().astype(np.float32)),
            torch.arange(3 * F, dtype=torch.int32).reshape(F, 3), H, W)


def raster_plan_cases():
    cases = dict(rasterize_edge_cases("cpu"))
    for scale in (1e4, 1e10):
        for seed in (0, 1):
            cases[f"far_{scale:.0e}_seed{seed}"] = raster_far_mesh(scale,
                                                                   seed)
    return cases


RASTER_PLAN_CASES = sorted(raster_plan_cases())


def _pixel_centres(H, W):
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32) + 0.5,
                            torch.arange(W, dtype=torch.float32) + 0.5,
                            indexing="ij")
    return xs.reshape(-1, 1), ys.reshape(-1, 1)


@pytest.mark.parametrize("case", RASTER_PLAN_CASES)
def test_raster_bins_hold_every_pair_the_box_test_admits(case):
    uv, z, faces, H, W = raster_plan_cases()[case]
    if faces.shape[0] == 0:
        return
    _, e = raster_plan(uv, z, faces, H, W)
    t = rc.face_terms(uv, z, faces, 1e-4)
    px, py = _pixel_centres(H, W)
    covered, _ = rc.cover(px, py, t)
    in_box = (t["valid"][None] & (px >= t["xlo"][None])
              & (px <= t["xhi"][None]) & (py >= t["ylo"][None])
              & (py <= t["yhi"][None])).numpy()
    tx = (px[:, 0].long() // rc.TILE).numpy()[:, None]
    ty = (py[:, 0].long() // rc.TILE).numpy()[:, None]
    listed = e["binned"][None] & (tx >= e["x0"][None]) \
        & (tx <= e["x1"][None]) & (ty >= e["y0"][None]) \
        & (ty <= e["y1"][None])
    held = listed | e["large"][None]
    assert not (in_box & ~held).any()
    assert not (covered.numpy() & ~held).any()
    # a face listed in a tile has a pixel centre in the tile's span of
    # rows and of columns that its range was computed from
    assert (e["x0"] <= e["x1"]).all() and (e["y0"] <= e["y1"]).all()
    if case.startswith("far_"):
        assert e["large"].any() and e["binned"].any()
        assert (~e["hit"] & t["valid"].numpy()).any()  # boxes off the map
        assert covered.any()


@pytest.mark.parametrize("case", RASTER_PLAN_CASES)
def test_raster_bins_stay_within_the_allocated_capacity(case):
    uv, z, faces, H, W = raster_plan_cases()[case]
    F = faces.shape[0]
    plan, e = raster_plan(uv, z, faces, H, W)
    nx = np.where(e["binned"], e["x1"] - e["x0"] + 1, 0)
    ny = np.where(e["binned"], e["y1"] - e["y0"] + 1, 0)
    assert (nx <= rc.SPAN).all() and (ny <= rc.SPAN).all()
    lay = rc.bin_layout(F, H, W)
    assert int((nx * ny).sum()) <= lay["capacity"]
    assert int(e["large"].sum()) <= F
    assert lay["tiles"] == -(-H // rc.TILE) * -(-W // rc.TILE)
    # chip_smoke.py holds the kernel's counters to the plan's
    counts = np.zeros((lay["gy"], lay["gx"]), np.int64)
    for f in np.flatnonzero(e["binned"]):
        counts[e["y0"][f]:e["y1"][f] + 1, e["x0"][f]:e["x1"][f] + 1] += 1
    assert np.array_equal(plan["counts"].numpy(), counts)
    assert plan["entries"] == int((nx * ny).sum())
    assert plan["n_large"] == int(e["large"].sum())


@pytest.mark.parametrize("case", RASTER_PLAN_CASES)
def test_raster_tiles_from_their_bins_give_the_plain_map(case):
    """``rasterize_tiles`` emulated: each warp's band of ``32 / TILE`` rows
    of a tile takes the largest clamped 1/z over the faces of the tile's
    list and of the large faces that meet the tile whose box meets the
    band's extreme pixel centres, and writes its reciprocal."""
    uv, z, faces, H, W = raster_plan_cases()[case]
    ref = rc.rasterize_depth_plain(uv, z, faces, H, W)
    if faces.shape[0] == 0:
        assert (ref == 0).all()
        return
    _, e = raster_plan(uv, z, faces, H, W)
    t = rc.face_terms(uv, z, faces, 1e-4)
    box = [t[k].numpy() for k in ("xlo", "xhi", "ylo", "yhi")]
    T, rows = rc.TILE, 32 // rc.TILE
    f32 = np.float32
    got = torch.zeros((H, W))
    large = np.flatnonzero(e["large"])

    def meets(ids, xl, xh, yl, yh):
        b = [box[k][ids] for k in range(4)]
        return ids[(b[0] <= f32(xh - 0.5)) & (b[1] >= f32(xl + 0.5))
                   & (b[2] <= f32(yh - 0.5)) & (b[3] >= f32(yl + 0.5))]

    for y0 in range(0, H, T):
        for x0 in range(0, W, T):
            tx, ty = x0 // T, y0 // T
            xh, yh = min(x0 + T, W), min(y0 + T, H)
            own = np.flatnonzero(e["binned"] & (e["x0"] <= tx)
                                 & (e["x1"] >= tx) & (e["y0"] <= ty)
                                 & (e["y1"] >= ty))
            staged = np.concatenate([own, meets(large, x0, xh, y0, yh)])
            for wy in range(y0, yh, rows):
                wh = min(wy + rows, H)
                ids = torch.from_numpy(meets(staged, x0, xh, wy, wh))
                if len(ids) == 0:
                    continue
                ys, xs = torch.meshgrid(
                    torch.arange(wy, wh, dtype=torch.float32) + 0.5,
                    torch.arange(x0, xh, dtype=torch.float32) + 0.5,
                    indexing="ij")
                inside, inv_z = rc.cover(xs.reshape(-1, 1),
                                         ys.reshape(-1, 1),
                                         {k: v[ids] for k, v in t.items()})
                # the largest 1/z, then one reciprocal: 1/x rounds
                # monotonically, so it is the least depth
                best = torch.where(inside, inv_z, torch.zeros_like(inv_z))
                best = best.amax(1).reshape(wh - wy, xh - x0)
                got[wy:wh, x0:xh] = torch.where(best > 0, 1.0 / best,
                                                torch.zeros_like(best))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("case", RASTER_PLAN_CASES)
def test_raster_division_skip_rejects_no_covered_pair(case):
    """The tile kernel's early exit (``inv_depth``): where n1 or n2 has
    the other sign than denom and |n| ≥ fl(|denom|·2^-100), the pair is
    never covered; it ends some of the pairs in a box that the
    barycentrics reject."""
    uv, z, faces, H, W = raster_plan_cases()[case]
    if faces.shape[0] == 0:
        return
    t = rc.face_terms(uv, z, faces, 1e-4)
    px, py = _pixel_centres(H, W)
    covered, _ = rc.cover(px, py, t)
    dx, dy = px - t["u0"][None], py - t["v0"][None]
    n1 = dx * t["e2y"][None] - dy * t["e2x"][None]
    n2 = t["e1x"][None] * dy - t["e1y"][None] * dx
    denom = t["denom"][None]
    tiny = denom.abs() * 2.0 ** -100
    assert bool((tiny[0, t["valid"]] > 0).all())
    skip = torch.where(denom > 0, (n1 <= -tiny) | (n2 <= -tiny),
                       (n1 >= tiny) | (n2 >= tiny))
    assert not bool((skip & covered).any())
    in_box = (t["valid"][None] & (px >= t["xlo"][None])
              & (px <= t["xhi"][None]) & (py >= t["ylo"][None])
              & (py <= t["yhi"][None]))
    outside = in_box & ~covered
    if int(outside.sum()) > 100:
        assert int((skip & outside).sum()) > 0


@pytest.mark.parametrize("case", RASTER_PLAN_CASES + ["head", "cube_head"])
def test_raster_plain_row_cull_changes_no_map(case):
    """The plain version, whose pixel blocks take only the faces whose box
    meets their rows, against every face at every pixel (``cover``), at
    pixel blocks that end mid-row."""
    if case in ("head", "cube_head"):
        verts, faces = (head_mesh(0, n_lat=12, n_lon=20) if case == "head"
                        else cube_head_mesh(4, 5))
        K = torch.tensor([[400.0, 0, 40], [0, 400.0, 32], [0, 0, 1]])
        uv, z = rc.project(torch.from_numpy(verts), K, torch.eye(4))
        faces, H, W = torch.from_numpy(faces), 64, 80
    else:
        uv, z, faces, H, W = raster_plan_cases()[case]
    dense = torch.zeros((H, W))
    if faces.shape[0]:
        px, py = _pixel_centres(H, W)
        inside, inv_z = rc.cover(px, py, rc.face_terms(uv, z, faces, 1e-4))
        depth = torch.where(inside, 1.0 / inv_z,
                            torch.full_like(inv_z, float("inf")))
        best = depth.amin(1).reshape(H, W)
        dense = torch.where(torch.isinf(best), torch.zeros_like(best), best)
    for pb in (97, 4096):
        culled = rc.rasterize_depth_plain(uv, z, faces, H, W, pixel_block=pb,
                                          face_chunk=64)
        assert torch.equal(culled, dense)
    if case in ("head", "cube_head"):
        assert int((culled > 0).sum()) > 0.1 * H * W


@pytest.mark.parametrize("n_xz, n_y", [(4, 5), (60, 75)])
def test_cube_head_mesh_has_no_pole(n_xz, n_y):
    """The pole-free stand-in: 4·(2·n_xz·n_y + n_xz²) faces (50,400 at the
    main case's size), each vertex in at most six, every face wound
    outwards, on the same head as ``head_mesh`` (its extent along each
    axis within 2 %)."""
    verts, faces = cube_head_mesh(n_xz, n_y)
    assert faces.shape == (4 * (2 * n_xz * n_y + n_xz ** 2), 3)
    assert faces.min() == 0 and faces.max() == len(verts) - 1
    assert np.bincount(faces.ravel()).max() <= 6
    v = verts.astype(np.float64)
    c = v - v.mean(0)
    n = np.cross(v[faces[:, 1]] - v[faces[:, 0]],
                 v[faces[:, 2]] - v[faces[:, 0]])
    assert ((n * c[faces].mean(1)).sum(1) > 0).all()
    ref = head_mesh(0)[0]
    span = verts.max(0) - verts.min(0)
    ref_span = ref.max(0) - ref.min(0)
    assert np.allclose(span, ref_span, rtol=0.02), (span, ref_span)
