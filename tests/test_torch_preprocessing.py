"""The port's preprocessing (``diner_tpu_torch.preprocessing``, the two
preprocess CLIs) against the JAX package's on the CPU.

Mirrors ``tests/test_preprocessing.py``, ``tests/test_preprocess_facescape.py``
and ``tests/test_preprocess_multiface.py`` on the same fabricated inputs, and
holds the plain version of kernel R (``ops/rasterize_cuda.py``) against
``diner_tpu.preprocessing.rasterize_depth`` on seeded meshes: coverage
identical at every pixel centre more than ``EDGE_PX`` from every projected
edge (measured in f64), depth within ``DEPTH_RTOL`` where both cover. The
collapsed-face fault of the JAX function (a zero-area face covers the whole
map, or a whole row of pixel centres) is pinned beside the port's repair.
The CLIs run in process with ``--device cpu`` and are held against the JAX
pipeline's own output files.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diner_tpu.preprocessing import rasterize_depth as j_rasterize_depth
from diner_tpu_torch.ops import rasterize_cuda
from diner_tpu_torch.preprocessing import (
    apply_color_calibration,
    color_calibration_affine,
    masked_downsampling,
    rasterize_depth,
)
from diner_tpu_torch.preprocessing.facescape_pipeline import (
    get_cam_angles,
    inv_extrinsics,
    load_ply,
    silhouette_crop_bbx,
    to_homogeneous_trafo,
    undistort_image,
)
from diner_tpu_torch.preprocessing.rasterize import load_obj_vertices_faces
from tests.test_preprocess_facescape import _write_subject as _facescape_raw
from tests.test_preprocess_multiface import _write_subject as _multiface_raw

EDGE_PX = 1e-3     # pixel centres this close to a projected edge may differ
DEPTH_RTOL = 1e-5  # JAX's matmul projection against the port's ordered sums


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers at once on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(verts, faces, K, Rt, H, W, **kw):
    return rasterize_depth(verts, faces, K, Rt, H, W, device="cpu",
                           **kw).numpy()


def _jax(verts, faces, K, Rt, H, W, **kw):
    return np.asarray(j_rasterize_depth(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(K),
        jnp.asarray(Rt), H, W, **kw))


# ------------------------------------------- mirrors of test_preprocessing

def test_rasterize_quad_depth():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    H = W = 32
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    Rt = np.eye(4, dtype=np.float32)
    d = _port(verts, faces, K, Rt, H, W, pixel_block=256, face_chunk=2)
    assert abs(d[16, 16] - 2.0) < 1e-3
    assert d[1, 1] == 0.0
    covered = (d > 0).sum()
    assert 18 * 18 < covered < 22 * 22
    np.testing.assert_array_equal(d, _jax(verts, faces, K, Rt, H, W,
                                          pixel_block=256, face_chunk=2))


def test_rasterize_depth_order():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2],
                      [-1, -1, 1], [1, -1, 1], [0, 1, 1]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    H = W = 16
    K = np.array([[8.0, 0, 8], [0, 8.0, 8], [0, 0, 1]], np.float32)
    d = _port(verts, faces, K, np.eye(4, dtype=np.float32), H, W,
              pixel_block=64, face_chunk=2)
    np.testing.assert_allclose(d[d > 0].min(), 1.0, atol=1e-3)


def test_obj_parser(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    v, f = load_obj_vertices_faces(p)
    assert v.shape == (4, 3)
    assert f.shape == (2, 3)
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3]])


def test_masked_downsampling_matches_torch_reference():
    from diner_tpu.preprocessing import masked_downsampling as j_masked
    rng = np.random.RandomState(0)
    H = W = 16
    x = rng.rand(H, W, 3).astype(np.float32)
    mask = (rng.rand(H, W, 1) > 0.4).astype(np.float32)
    ours = masked_downsampling(x, mask, 4, bg_color=0.25)
    xt = torch.from_numpy(np.transpose(x, (2, 0, 1)))[None].clone()
    mt = torch.from_numpy(np.transpose(mask, (2, 0, 1)))[None]
    xt.permute(0, 2, 3, 1)[mt[:, 0] < 1] = 0
    x_sum = torch.nn.functional.avg_pool2d(xt, 4, 4, divisor_override=1)
    m_sum = torch.nn.functional.avg_pool2d(mt, 4, 4, divisor_override=1)
    rows = (np.arange(H // 4) * 4 + 2).clip(0, H - 1)
    m_nearest = mask[rows][:, rows][..., 0]
    fg = torch.from_numpy(m_nearest > 0)
    ref = x_sum.clone()
    ref.permute(0, 2, 3, 1)[0][fg] = (x_sum / m_sum.clamp(min=1e-12)
                                      ).permute(0, 2, 3, 1)[0][fg]
    ref.permute(0, 2, 3, 1)[0][~fg] = 0.25
    ref = ref[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_array_equal(ours, j_masked(x, mask, 4, bg_color=0.25))


def test_color_calibration_recovers_affine():
    from diner_tpu.preprocessing import (
        color_calibration_affine as j_affine)
    rng = np.random.RandomState(1)
    n_verts = 400
    true_colors = rng.rand(n_verts, 3).astype(np.float64) * 0.8 + 0.1
    A_true = np.array([[0.9, 0.02, 0.0, 0.05],
                       [0.0, 1.1, 0.01, -0.03],
                       [0.01, 0.0, 0.95, 0.02]])
    idx0 = np.arange(0, 380)
    idx1 = np.arange(20, 400)
    c0 = true_colors[idx0]
    h = np.concatenate([true_colors[idx1], np.ones((len(idx1), 1))], -1)
    c1 = h @ A_true.T
    out = color_calibration_affine([c0, c1], [idx0, idx1], n_verts)
    corrected = apply_color_calibration(c1[None], out[1])[0]
    mean_ref = 0.5 * (true_colors[idx1] + c1)
    overlap = np.isin(idx1, idx0)
    err_before = np.abs(c1[overlap] - mean_ref[overlap]).mean()
    err_after = np.abs(corrected[overlap] - mean_ref[overlap]).mean()
    assert err_after < 0.5 * err_before
    for a, b in zip(out, j_affine([c0, c1], [idx0, idx1], n_verts)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------- kernel R's plain version

def _seeded_mesh(seed, F, H, W):
    """Random triangles of both orientations at overlapping depths, some
    partly off screen, some with a vertex behind ``znear`` or at z = 0 →
    (verts, faces, K, Rt (3, 4)) for an H×W map."""
    rng = np.random.RandomState(seed)
    z_c = rng.uniform(0.6, 3.0, F)
    xy_c = rng.uniform(-0.8, 0.8, (F, 2)) * z_c[:, None]
    size = rng.uniform(0.05, 0.6, F)[:, None, None]
    off = rng.normal(size=(F, 3, 3)) * size
    tri = np.concatenate([xy_c, z_c[:, None]], -1)[:, None] + off
    # vertices nearer than 0.3 project hundreds of pixels off screen, where
    # one ulp of the projection (JAX's matmul against the port's ordered
    # sums) moves the interpolated depth by more than DEPTH_RTOL: in f64 a
    # face with a vertex at z = 0.03 puts both packages ~1e-5 from the truth
    tri[..., 2] = np.maximum(tri[..., 2], 0.3)
    tri[:F // 10, 0, 2] = rng.uniform(-0.5, 5e-5, F // 10)  # behind znear
    tri[F // 10, 1, 2] = 0.0                                 # on the plane
    # a rigid camera: the mesh is given in world space
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.05, -0.03, 0.1])
    world = (tri.reshape(-1, 3) - t) @ R  # cam = R·world + t
    verts = world.astype(np.float32)
    faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    f = 0.6 * max(H, W)
    K = np.array([[f, 0, W / 2], [0, f * 1.1, H / 2], [0, 0, 1]], np.float32)
    Rt = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    return verts, faces, K, Rt


def _edge_distance(verts, faces, K, Rt, H, W):
    """Each pixel centre's distance (f64) to the nearest projected edge
    segment of a face whose vertices all lie beyond ``znear``."""
    v = verts.astype(np.float64) @ Rt[:, :3].T.astype(np.float64) \
        + Rt[:, 3].astype(np.float64)
    z = v[:, 2]
    uv = v[:, :2] / np.where(z == 0, 1e-9, z)[:, None] \
        * K.astype(np.float64)[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
    ok = (z[faces] > 1e-4).all(-1)
    a = uv[faces[ok]].reshape(-1, 3, 2)
    p0 = a.reshape(-1, 2)
    p1 = a[:, [1, 2, 0]].reshape(-1, 2)
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    pix = np.stack([xs.ravel(), ys.ravel()], -1)
    d = p1 - p0
    t = ((pix[:, None] - p0[None]) * d[None]).sum(-1) \
        / np.maximum((d * d).sum(-1), 1e-300)[None]
    t = np.clip(t, 0, 1)
    near = p0[None] + t[..., None] * d[None]
    return np.sqrt(((pix[:, None] - near) ** 2).sum(-1)).min(1).reshape(H, W)


@pytest.mark.parametrize("seed,H,W,F", [(0, 24, 40, 60), (1, 33, 17, 150),
                                        (2, 48, 64, 400)])
def test_rasterizer_matches_jax(seed, H, W, F):
    verts, faces, K, Rt = _seeded_mesh(seed, F, H, W)
    ours = _port(verts, faces, K, Rt, H, W, pixel_block=512, face_chunk=64)
    ref = _jax(verts, faces, K, Rt, H, W, pixel_block=512, face_chunk=64)
    far = _edge_distance(verts, faces, K, Rt, H, W) > EDGE_PX
    assert far.mean() > 0.9
    np.testing.assert_array_equal((ours > 0)[far], (ref > 0)[far])
    both = far & (ours > 0) & (ref > 0)
    assert both.sum() > 0.2 * H * W  # overlapping, not vacuous
    np.testing.assert_allclose(ours[both], ref[both], rtol=DEPTH_RTOL)
    # the (3, 4) and (4, 4) extrinsics and any tiling give the same map
    Rt44 = np.vstack([Rt, [0, 0, 0, 1]]).astype(np.float32)
    np.testing.assert_array_equal(
        ours, _port(verts, faces, K, Rt44, H, W, pixel_block=97,
                    face_chunk=F))


def _one_triangle():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2], [0, 0, 3]],
                     np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    K = np.array([[8.0, 0, 8], [0, 8.0, 8], [0, 0, 1]], np.float32)
    return verts, faces, K, np.eye(4, dtype=np.float32)


def test_collapsed_face_covers_the_map_in_jax_and_nothing_in_the_port():
    """A face [3, 3, 3] (denom 0): JAX clamps denom to 1e-12, gets b1 = b2
    = 0 at every pixel and covers all 256 pixels at its depth; the port
    drops it and covers what the mesh without it covers."""
    verts, faces, K, Rt = _one_triangle()
    base = _port(verts, faces, K, Rt, 16, 16)
    assert (base > 0).sum() == 32
    faces2 = np.concatenate([faces, [[3, 3, 3]]]).astype(np.int32)
    ref = _jax(verts, faces2, K, Rt, 16, 16)
    assert (ref > 0).sum() == 256
    np.testing.assert_allclose(ref[0, 0], 3.0)
    np.testing.assert_array_equal(_port(verts, faces2, K, Rt, 16, 16), base)


def test_zero_area_face_on_a_pixel_row():
    """Three collinear vertices on the row of pixel centres v = 8.5,
    spanning u 7.5-9.5: JAX covers all 16 pixels of row 8, the port none;
    beside a real triangle the port's map is the triangle's."""
    verts, faces, K, Rt = _one_triangle()
    line = np.array([[-0.125, 0.125, 2], [0.375, 0.125, 2],
                     [0.125, 0.125, 2]], np.float32)
    ref = _jax(line, np.array([[0, 1, 2]], np.int32), K, Rt, 16, 16)
    assert (ref > 0).sum() == 16 and (ref[8] > 0).all()
    assert (_port(line, np.array([[0, 1, 2]], np.int32), K, Rt, 16,
                  16) == 0).all()
    both = np.concatenate([verts, line]).astype(np.float32)
    faces2 = np.concatenate([faces, [[4, 5, 6]]]).astype(np.int32)
    np.testing.assert_array_equal(_port(both, faces2, K, Rt, 16, 16),
                                  _port(verts, faces, K, Rt, 16, 16))


def test_rasterize_depth_edges():
    """No faces → zeros; indices outside the vertices → ValueError; the
    plain version runs on the CPU, the kernel entry refuses CPU tensors."""
    verts, faces, K, Rt = _one_triangle()
    assert (_port(verts, np.zeros((0, 3), np.int32), K, Rt, 5, 7)
            == 0).all()
    with pytest.raises(ValueError, match="outside"):
        _port(verts, np.array([[0, 1, 4]], np.int32), K, Rt, 4, 4)
    uv, z = rasterize_cuda.project(torch.from_numpy(verts),
                                   torch.from_numpy(K), torch.from_numpy(Rt))
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda.rasterize_depth_kernel(uv, z, torch.from_numpy(faces),
                                              4, 4)


# ----------------------------------- mirrors of test_preprocess_facescape

def test_pure_helpers():
    E = to_homogeneous_trafo(np.array(
        [[[1, 0, 0, 2.0], [0, 1, 0, 3.0], [0, 0, 1, 4.0]]]))
    assert E.shape == (1, 4, 4) and E[0, 3, 3] == 1
    np.testing.assert_allclose(inv_extrinsics(inv_extrinsics(E)), E,
                               atol=1e-12)
    Rt = np.array([[1.0, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0]])
    ang = get_cam_angles(Rt)
    assert abs(ang["azimuth"]) < 1e-6 and abs(ang["elevation"]) < 1e-6
    rng = np.random.RandomState(0)
    img = rng.rand(24, 32, 3)
    K = np.array([[40.0, 0, 16], [0, 40, 12], [0, 0, 1]])
    np.testing.assert_allclose(undistort_image(img, K, np.zeros(5)), img,
                               atol=1e-9)
    mask = np.zeros((24, 32), bool)
    mask[6:18, 10:22] = True
    t, b, l, r = silhouette_crop_bbx(mask, cam_center_x=1.0)
    assert (b - t) == 24 and (r - l) == 24
    t2, b2, l2, r2 = silhouette_crop_bbx(mask, cam_center_x=-1.0)
    assert (b2 - t2) == 24 and (r2 - l2) == 24


def test_load_ply_binary(tmp_path):
    verts = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    p = tmp_path / "m.ply"
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                b"element vertex 3\nproperty float x\nproperty float y\n"
                b"property float z\nelement face 1\n"
                b"property list uchar int vertex_indices\nend_header\n")
        verts.astype("<f4").tofile(f)
        f.write(bytes([3]))
        np.array([0, 1, 2], "<i4").tofile(f)
    v, fa = load_ply(p)
    np.testing.assert_allclose(v, verts)
    assert fa.tolist() == [[0, 1, 2]]


def _facescape_cli(raw, out, rt_scale, lmk):
    from diner_tpu_torch.preprocess_facescape import main
    return main(["--dir_in", str(raw), "--dir_out", str(out), "--rt_scale",
                 str(rt_scale), "--landmarks", str(lmk), "--crop_out", "16",
                 "--device", "cpu"])


def test_preprocess_facescape_end_to_end(tmp_path, capsys):
    raw, rt_scale, lmk = _facescape_raw(tmp_path)
    out = tmp_path / "OUT" / "001"
    assert _facescape_cli(raw, out, rt_scale, lmk) == {"1_neutral": True}
    assert "1_neutral: ok" in capsys.readouterr().out

    scan = out / "01"
    view = scan / "view_00000"
    rgba = np.asarray(Image.open(view / "rgba.png"))
    assert rgba.shape == (16, 16, 4)
    depth = np.asarray(Image.open(view / "depth.png")).astype(np.float32)
    fg = depth > 0
    assert fg.any()
    np.testing.assert_allclose(depth[fg] * 1e-4, 1.0, atol=1e-3)
    np.testing.assert_array_equal(rgba[..., 3] > 0, fg)
    cams = json.loads((scan / "cameras.json").read_text())
    assert "0" in cams and "angles" in cams["0"]
    K = np.asarray(cams["0"]["intrinsics"])
    np.testing.assert_allclose(K[0, 0], 40.0 * 16 / 24, rtol=1e-12)
    lmks = np.loadtxt(scan / "3dlmks.npy")
    assert lmks.shape == (3, 3)
    np.testing.assert_allclose(lmks[0], [-0.2, -1.0, -0.2], atol=1e-6)
    assert (view / "rgba_colorcalib.png").exists()


def test_preprocess_facescape_matches_jax(tmp_path):
    """Every file the port CLI writes equals the JAX pipeline's on the same
    raw subject (two views, the second rotated and with distortion, so the
    calibration fits two cameras)."""
    from diner_tpu.preprocessing.facescape_pipeline import process_pose
    raw, rt_scale, lmk = _facescape_raw(tmp_path)
    pose = raw / "1_neutral"
    cam = json.loads((pose / "params.json").read_text())
    c, s = np.cos(0.15), np.sin(0.15)
    cam.update({"1_K": [[42.0, 0.0, 15.0], [0.0, 41.0, 12.5],
                        [0.0, 0.0, 1.0]],
                "1_Rt": [[c, 0, s, -150.0], [0, 1, 0, 10.0],
                         [-s, 0, c, 40.0]],
                "1_distortion": [0.01, -0.002, 0.001, 0.0005, 0.0],
                "1_width": 32, "1_height": 24, "1_valid": True})
    (pose / "params.json").write_text(json.dumps(cam))
    rng = np.random.RandomState(1)
    Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(
        pose / "1.jpg")
    out = tmp_path / "OUT" / "001"
    assert _facescape_cli(raw, out, rt_scale, lmk) == {"1_neutral": True}
    ref = tmp_path / "REF" / "001"
    align = json.loads(rt_scale.read_text())
    assert process_pose(pose, ref, align, np.load(lmk)["v10"], crop_out=16)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert {f"01/view_0000{i}/{n}.png" for i in (0, 1)
            for n in ("rgba", "depth")} | {"01/cameras.json",
                                           "01/3dlmks.npy"} <= set(
        map(str, files))
    assert files == sorted(p.relative_to(out) for p in out.rglob("*")
                           if p.is_file())
    for f in files:
        if f.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(out / f)),
                                          np.asarray(Image.open(ref / f)),
                                          err_msg=str(f))
        elif f.name == "cameras.json":
            assert json.loads((out / f).read_text()) == json.loads(
                (ref / f).read_text())
        else:
            assert (out / f).read_bytes() == (ref / f).read_bytes(), f


# ----------------------------------- mirrors of test_preprocess_multiface

def test_depth_codec_roundtrip():
    from diner_tpu_torch import preprocess_multiface as pm
    x = np.array([[0.0, 100.0, 6553.5, 99999.0]], np.float32)
    back = pm.uint16_2_float32(pm.float32_2_uint16(x))
    np.testing.assert_allclose(back[0, :3], [0.0, 100.0, 6553.5])
    assert back[0, 3] == 6553.5


def test_rendered_depth_values(tmp_path):
    from diner_tpu_torch import preprocess_multiface as pm
    subj = _multiface_raw(tmp_path)
    written = pm.main(["--root", str(tmp_path), "-H", "24", "-W", "32",
                       "--device", "cpu"])
    dpath = subj / "depths" / "SEQ1" / "cam001" / "000001.png"
    assert written == [dpath]
    d = pm.uint16_2_float32(np.asarray(Image.open(dpath)))
    a = np.asarray(Image.open(subj / "masks" / "SEQ1" / "cam001" /
                              "000001.png"))
    assert abs(d[12, 16] - 1000.0) < 0.2
    assert a[12, 16] == 255
    assert d[0, 0] == 0.0 and a[0, 0] == 0
    np.testing.assert_array_equal(a > 0, d > 0)


def test_preprocess_multiface_pngs_match_plain_map_and_jax(tmp_path):
    """Two cameras (one rotated) and a tilted mesh of 4 faces at 40×56: the
    depth PNG is ``float32_2_uint16`` of the plain version's map, the mask
    255 where it is not 0, and both equal the JAX script's files."""
    from diner_tpu.data.multiface import load_krt as j_load_krt
    from diner_tpu_torch import preprocess_multiface as pm
    from diner_tpu_torch.data.multiface import load_krt
    from tests.test_torch_mvs_data import import_script
    subj = _multiface_raw(tmp_path)
    c, s = np.cos(0.2), np.sin(0.2)
    lines = (subj / "KRT").read_text().splitlines()
    lines += ["cam002", "45.0 0 27", "0 44.0 20.5", "0 0 1", "0 0 0 0 0",
              f"{c} 0 {s} -150", "0 1 0 20", f"{-s} 0 {c} 30", ""]
    (subj / "KRT").write_text("\n".join(lines) + "\n")
    (subj / "tracked_mesh" / "SEQ1" / "000001.obj").write_text(
        "v -200 -200 900\nv 200 -200 1100\nv 200 200 1000\n"
        "v -200 200 950\nv 0 10 1020\nf 1 2 5\nf 2 3 5\nf 3 4 5\nf 4 1 5\n")
    written = pm.main(["--root", str(tmp_path), "-H", "40", "-W", "56",
                       "--device", "cpu"])
    assert len(written) == 2
    krt = load_krt(subj / "KRT")
    verts, faces = load_obj_vertices_faces(subj / "tracked_mesh" / "SEQ1" /
                                           "000001.obj")
    jscript = import_script("preprocess_multiface")
    ref_root = tmp_path / "ref"
    jscript.process_frame(subj / "tracked_mesh" / "SEQ1" / "000001.obj",
                          j_load_krt(subj / "KRT"), ref_root, "SEQ1", 40, 56)
    for cam in ("cam001", "cam002"):
        uv, z = rasterize_cuda.project(
            torch.from_numpy(verts), torch.from_numpy(krt[cam]["intrin"]),
            torch.from_numpy(krt[cam]["extrin"]))
        plain = rasterize_cuda.rasterize_depth_plain(
            uv, z, torch.from_numpy(faces), 40, 56).numpy()
        assert (plain > 0).mean() > 0.05
        for kind in ("depths", "masks"):
            rel = Path(kind) / "SEQ1" / cam / "000001.png"
            got = np.asarray(Image.open(subj / rel))
            if kind == "depths":
                np.testing.assert_array_equal(got, pm.float32_2_uint16(plain))
                depth = got
            else:
                np.testing.assert_array_equal(got > 0, depth != 0)
                assert set(np.unique(got)) <= {0, 255}
            np.testing.assert_array_equal(
                got, np.asarray(Image.open(ref_root / rel)), err_msg=str(rel))
