"""Kernels A, B and C as designed for Hopper, the DCN backward and the
top-1 kNN: kernel C's regime planner and
the build plan (on the CPU), and the kernels against their plain versions
at the edges of their designs (tests marked ``cuda``, which skip without a
card; ``chip_smoke.py`` runs the same cases in its ``kernel``,
``kernel_bwd`` and ``kernel_gather`` phases).

Kernel C must equal ``index_select`` bit for bit in every regime (narrow
rows, wide rows, a thread per unit): every row width of the path and
between, aligned, at odd offsets and with strided rows, int32 and int64
indices, P = 1, P no multiple of the rows a lane or warp takes, R = 1 and
out-of-range indices (clamped). Kernel A must stay within 1e-5 of the plain
composite at K around one and two 32-sample chunks, with R no multiple of
the rays per block, with and without a white background, for the field's
strided views and for a contiguous rgb. Kernel B must stay within 1e-5 of
the plain ``composite_bwd`` on d_rgb and within 1e-5 of its largest value
on d_sigma (its T and suffix sums are summed in tree order within each
chunk) on ``chip_smoke.COMPOSITE_BWD_CASES`` (K around one and two chunks,
on both sides of the register path's K <= 64, R = 4096 and 4097, and the
train loop's 8192 x 40), white or not, with only g_rgb or with g_depth and
g_w, strided or contiguous rgb, with samples at alpha ~ 1 or without.
The top-1 kNN must return its plain version's indices exactly (both
compute |v|² − 2·p·v with the same roundings): N and V no multiples of the
block or the tile, V = 1, duplicated vertices (the first copy), exact
ties, two scenes with different vertex sets, strided points, N = 0, ties
between mirrored vertices in different tiles
(``chip_smoke.knn_edge_cases``, which ``kernel_knn`` runs too), and on
ray-ordered points, culling the share of tiles the CPU emulation of its
plan culls (``tests/test_torch_kernel_plans.py``). The DCN backward's tap
design (P = H·W, two launches) must match the plain version at odd H and
W, C = 5 and 32, f32 and bf16, with offsets that spill and with every
point spilled.
Kernel R (the mesh z-buffer) must equal its plain version bit for bit on
``chip_smoke.rasterize_edge_cases`` (both windings, |denom| on both sides
of 1e-12, a collapsed face, vertices at and behind znear and at z = 0,
edges through pixel centres, slivers, faces larger than the map and off
it, F = 0, sizes no multiple of the 16×16 tile or the 256-face chunk, a
crowded tile), which ``kernel_rasterize`` runs too; on the CPU the plain
version must give the same map at any tiling.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (COMPOSITE_BWD_CASES, composite_bwd_case,
                        gather_edge_tables, knn_edge_cases,
                        rasterize_edge_cases)
from diner_tpu_torch.ops import composite as plain
from diner_tpu_torch.ops import composite_cuda, cuda_build, gather_cuda

OUT_ADDR = 1 << 20  # the wrapper's outputs come from torch.empty: aligned


EDGE_PLANS = {
    "c1_f32": ("narrow", 4),
    "c1_f32_offset_4B": ("narrow", 4),
    "c3_f32": ("narrow", 4),
    "c5_f32_offset_36B": ("narrow", 4),
    "c5_f32_strided_rows": ("narrow", 4),
    "c7_bf16_offset_2B": ("units", 2),
    "c8_f32": ("narrow", 4),
    "c16_f32": ("units", 16),
    "c128_f32": ("wide", 16),
    "c512_bf16": ("wide", 16),
    "c512_bf16_offset_4B": ("units", 4),
    "c1024_bf16": ("wide", 16),
    "c1024_bf16_strided_rows": ("wide", 16),
}


def _row_bytes(table):
    size = table.element_size()
    return (table.shape[1] * size,
            table.stride(0) * size if table.shape[0] > 1
            else table.shape[1] * size)


@pytest.mark.parametrize("name", sorted(EDGE_PLANS))
def test_row_gather_plan_at_the_edge_views(name):
    table = gather_edge_tables("cpu")[name]
    row_bytes, stride_bytes = _row_bytes(table)
    assert gather_cuda.plan(row_bytes, stride_bytes, table.data_ptr(),
                            OUT_ADDR) == EDGE_PLANS[name]


# chip_smoke.py's GATHER_CASES: (case, C, dtype) → (regime, unit bytes)
PATH_PLANS = [
    ("sampler_map_c5_f32", 5, torch.float32, ("narrow", 4)),
    ("sampler_map_c5_f32_pruned_stage", 5, torch.float32, ("narrow", 4)),
    ("latent_c512_bf16", 512, torch.bfloat16, ("wide", 16)),
    ("latent_corner_c512_bf16", 512, torch.bfloat16, ("wide", 16)),
    ("latent_corner_c512_bf16_train", 512, torch.bfloat16, ("wide", 16)),
    ("depth_c1_f32", 1, torch.float32, ("narrow", 4)),
    ("pair_row_c1024_bf16", 1024, torch.bfloat16, ("wide", 16)),
    ("lab_proxy_c128_f32", 128, torch.float32, ("wide", 16)),
]


@pytest.mark.parametrize("case,C,dtype,expected", PATH_PLANS,
                         ids=[p[0] for p in PATH_PLANS])
def test_row_gather_plan_at_the_path_shapes(case, C, dtype, expected):
    row_bytes = C * torch.empty((), dtype=dtype).element_size()
    assert gather_cuda.plan(row_bytes, row_bytes, 0, OUT_ADDR) == expected


def test_row_gather_plan_boundaries():
    plan = gather_cuda.plan
    assert plan(32, 32, 0, OUT_ADDR) == ("narrow", 4)    # in 4 B units
    assert plan(36, 36, 0, OUT_ADDR) == ("units", 4)       # above 32 B
    assert plan(240, 240, 0, OUT_ADDR) == ("units", 16)    # below 256 B
    assert plan(256, 256, 0, OUT_ADDR) == ("wide", 16)
    assert plan(6, 6, 0, OUT_ADDR) == ("units", 2)         # 2 B units
    assert plan(20, 20, 0, OUT_ADDR + 2) == ("units", 2)   # out at 2 B
    assert plan(1024, 1024, 8, OUT_ADDR) == ("units", 8)   # table at 8 B
    assert plan(1024, 1032, 0, OUT_ADDR) == ("units", 8)   # stride 8 B
    assert set(gather_cuda.REGIMES) == {"narrow", "units", "wide"}


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_PLANS))
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_row_gather_kernel_exact_in_every_regime(cuda, name, index_dtype):
    table = gather_edge_tables(cuda, seed=len(name))[name]
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 4000, (50_001,), generator=g).to(cuda, index_dtype)
    bad = torch.tensor([-5, 0, 3999, 4000, 10 ** 12, -(10 ** 12), 17])
    if index_dtype == torch.int32:
        bad = bad.clamp(-2 ** 31, 2 ** 31 - 1)
    bad = bad.to(cuda, index_dtype)
    for t, i in ((table, idx), (table, idx[:1]), (table, idx[:129]),
                 (table[:1], idx.clamp(max=0)), (table, bad)):
        before = gather_cuda.launches
        got = gather_cuda.row_gather_kernel(t, i)
        torch.cuda.synchronize()
        assert gather_cuda.launches == before + 1
        assert got.dtype == t.dtype and got.shape == (i.numel(), t.shape[1])
        assert torch.equal(got, t[i.long().clamp(0, t.shape[0] - 1)])


def _field_case(R, K, seed, device, contiguous_rgb):
    g = torch.Generator().manual_seed(seed)
    out = torch.rand((1, R, K, 4), generator=g)
    out[..., 3] = torch.randn((1, R, K), generator=g) * 2
    z = torch.sort(torch.rand((1, R, K), generator=g) * 1.5 + 0.5).values
    rays = torch.zeros((1, R, 8))
    rays[..., 7] = 2.5
    out, z, rays = (t.to(device) for t in (out, z, rays))
    rgb = out[..., :3].contiguous() if contiguous_rgb else out[..., :3]
    return rgb, out[..., 3], z, rays


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 31, 32, 33, 40, 64, 100])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("contiguous_rgb", [False, True])
def test_composite_kernel_across_chunks(cuda, K, white, contiguous_rgb):
    args = _field_case(4097, K, K + 7 * white, cuda, contiguous_rgb)
    before = composite_cuda.launches
    got = composite_cuda.composite_kernel(*args, white_bkgd=white)
    torch.cuda.synchronize()
    assert composite_cuda.launches == before + 1
    ref = plain.composite(*args, white_bkgd=white)
    for a, b in zip(got, ref):  # products and sums in another order
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", COMPOSITE_BWD_CASES)
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("with_g_w", [False, True])
@pytest.mark.parametrize("contiguous_rgb", [False, True])
@pytest.mark.parametrize("saturated", [False, True])
def test_composite_bwd_kernel_edges(cuda, R, K, white, with_g_w,
                                    contiguous_rgb, saturated):
    args = composite_bwd_case(R, K, white, with_g_w, contiguous_rgb, "cuda",
                              saturated)
    rgb, sigma, z, rays = args[:4]
    before = composite_cuda.bwd_launches
    got = composite_cuda.composite_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert composite_cuda.bwd_launches == before + 1
    ref = plain.composite_bwd(rgb, sigma, z, rays[..., 7], *args[4:])
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               atol=1e-5, rtol=0)
    scale = float(ref[1].abs().max())
    np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].cpu().numpy(),
                               atol=1e-5 * scale, rtol=0)


# ------------------------------------------------------- the build plan

def test_build_plan_hashes_the_shared_header(tmp_path, monkeypatch):
    """The headers under ``csrc/`` (``composite_scan.cuh``, included by
    kernels A and B) enter every library's hash, so an edited header
    rebuilds them, and nvcc gets ``-I`` on ``csrc/``."""
    import shutil
    pkg = tmp_path / "pkg"
    shutil.copytree(cuda_build.PKG_DIR / cuda_build.CSRC, pkg / "csrc")
    monkeypatch.setattr(cuda_build, "PKG_DIR", pkg)
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    header = pkg / "csrc" / "composite_scan.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    assert all(after[n] != before[n] for n in cuda_build.SOURCES)
    cmd = cuda_build.nvcc_command("composite_bwd", tmp_path / "x.so")
    assert cmd[cmd.index("-I") + 1] == str(pkg / "csrc")
    assert cmd[-1] == str(pkg / "csrc" / "composite_bwd.cu")


# the DCN sampler's backward (csrc/dcn_sample_bwd.cu): outputs relative to
# their largest magnitude, d_img as its f32 canvas before the cast, which
# f32 atomics sum in another order
DCN_BWD_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8, 9])
@pytest.mark.parametrize("C", [5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_scale", [True, False])
def test_dcn_sample_bwd_kernel_edges(cuda, W, C, dtype, with_scale):
    """The kernel against bilinear_sample_pix_bwd_plain at positions
    outside the image, on its borders and at exact integers."""
    from diner_tpu_torch.ops import dcn_cuda
    g = torch.Generator(device=cuda).manual_seed(W * 100 + C)
    N, H, P = 2, 7, 1001
    img = torch.randn((N, H, W, C), generator=g, device=cuda).to(dtype)
    x = torch.rand((N, P), generator=g, device=cuda) * (W + 3) - 2
    y = torch.rand((N, P), generator=g, device=cuda) * (H + 3) - 2
    x[:, ::7] = torch.floor(x[:, ::7])
    y[:, ::7] = torch.floor(y[:, ::7])
    scale = (torch.rand((N, P), generator=g, device=cuda)
             if with_scale else None)
    gout = torch.randn((N, P, C), generator=g, device=cuda).to(dtype)
    got = dcn_cuda.bilinear_sample_pix_bwd_kernel(img, x, y, scale, gout,
                                                  f32_d_img=True)
    torch.cuda.synchronize()
    ref = dcn_cuda.bilinear_sample_pix_bwd_plain(img, x, y, scale, gout,
                                                 f32_d_img=True)
    assert got[0].dtype == ref[0].dtype == torch.float32
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None
            continue
        err = (a - b).abs().max() / b.abs().max()
        assert err <= DCN_BWD_TOL, (i, float(err))



@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [5, 32])
@pytest.mark.parametrize("spread", ["grid", "spills", "all_spill"])
def test_dcn_sample_bwd_kernel_tap_design(cuda, dtype, C, spread):
    """The tap design (P = H·W) against the plain version: the pixel grid
    plus N(0, 1.5) offsets, N(0, 4) offsets (some corners beyond the
    ring) and every point 20 rows down (every valid corner a spill)."""
    from diner_tpu_torch.ops import dcn_cuda
    from test_torch_kernel_plans import dcn_tap_case
    std, shift = {"grid": (1.5, 0.0), "spills": (4.0, 0.0),
                  "all_spill": (0.3, 20.0)}[spread]
    args = [t.to(cuda) for t in dcn_tap_case(2, 29, 37, C, dtype, std,
                                              shift_y=shift, seed=C)]
    img, x, y, scale, gout = args
    assert dcn_cuda.tiled(img.shape, x.shape[1])
    before = dcn_cuda.launches
    got = dcn_cuda.bilinear_sample_pix_bwd_kernel(*args, f32_d_img=True)
    torch.cuda.synchronize()
    assert dcn_cuda.launches == before + 2
    ref = dcn_cuda.bilinear_sample_pix_bwd_plain(*args, f32_d_img=True)
    for i, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs().max() / b.abs().max()
        assert err <= DCN_BWD_TOL, (i, float(err))
    if spread != "grid":
        assert sum(int(s.sum()) for s in dcn_cuda.spilled_corners(
            img.shape, x, y)) > 0
    # without scale, and d_img in the image dtype
    got = dcn_cuda.bilinear_sample_pix_bwd_kernel(img, x, y, None, gout)
    ref = dcn_cuda.bilinear_sample_pix_bwd_plain(img, x, y, None, gout,
                                                 f32_d_img=True)
    assert got[0].dtype == dtype and got[3] is None
    err = (got[0].float() - ref[0]).abs().max() / ref[0].abs().max()
    assert err <= (1e-5 if dtype == torch.float32 else 2 ** -8)


@pytest.mark.cuda
def test_knn1_kernel_culls_as_its_plan(cuda):
    """Ray-ordered points: the kernel's indices equal the plain version's
    and it culls the share of (warp, tile) pairs the CPU emulation culls
    (the kernel's lb may round otherwise by a few ulps: 1 % apart)."""
    from chip_smoke import knn_ray_points
    from diner_tpu_torch.ops import knn_cuda
    from test_torch_kernel_plans import knn1_cull_emulation
    points, verts = knn_ray_points("cpu", n_rays=48, n_cand=128, V=3000)
    _, want = knn1_cull_emulation(points, verts)
    got, culled = knn_cuda.knn1_kernel_culled(points.to(cuda),
                                              verts.to(cuda))
    assert torch.equal(got.cpu(), knn_cuda.knn1_plain(points, verts))
    assert abs(culled - want) < 0.01, (culled, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(knn_edge_cases("cpu")))
def test_knn1_kernel_edges(cuda, case):
    from diner_tpu_torch.ops import knn_cuda
    points, verts, expected = knn_edge_cases(cuda)[case]
    before = knn_cuda.launches
    got = knn_cuda.knn1_kernel(points, verts)
    torch.cuda.synchronize()
    assert knn_cuda.launches == before + (points.shape[1] > 0)
    assert got.dtype == torch.int32 and got.shape == points.shape[:2]
    assert torch.equal(got, knn_cuda.knn1_plain(points, verts))
    if expected is not None:
        assert torch.equal(got, expected)
    if case == "duplicates":  # the first of two copies
        assert int(got.max()) < verts.shape[1] // 2


@pytest.mark.parametrize("case", sorted(rasterize_edge_cases("cpu")))
def test_rasterize_plain_is_tiling_invariant(case):
    """The plain version gives the same map at any (pixel_block,
    face_chunk) tiling: the min over faces is taken per face, in order."""
    from diner_tpu_torch.ops import rasterize_cuda
    uv, z, faces, H, W = rasterize_edge_cases("cpu")[case]
    ref = rasterize_cuda.rasterize_depth_plain(uv, z, faces, H, W)
    assert ref.shape == (H, W) and ref.dtype == torch.float32
    assert torch.equal(ref, rasterize_cuda.rasterize_depth_plain(
        uv, z, faces, H, W, pixel_block=7, face_chunk=5))
    if case == "denom_threshold":  # above 1e-12 covers its pixel centre
        assert ref[0, 0] == 2.0 and int((ref > 0).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(rasterize_edge_cases("cpu")))
def test_rasterize_kernel_edges(cuda, case):
    from diner_tpu_torch.ops import rasterize_cuda
    uv, z, faces, H, W = rasterize_edge_cases(cuda)[case]
    before = rasterize_cuda.launches
    got = rasterize_cuda.rasterize_depth_kernel(uv, z, faces, H, W)
    torch.cuda.synchronize()
    # bin, scan, scatter and tile kernels; the tile kernel alone at F = 0
    assert rasterize_cuda.launches == before + (4 if faces.shape[0] else 1)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    assert torch.equal(got, rasterize_cuda.rasterize_depth_plain(
        uv, z, faces, H, W))
