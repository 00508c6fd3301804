"""The port's depth-map fusion (``diner_tpu_torch/fusion``) and the fusing
half of its ``mvs.evaluate`` CLI against the JAX package's
(``diner_tpu/fusion``, ``scripts/mvs_test.py``), on the CPU.

The scene: two fronto-parallel planes (z = 2 left of x = 0, z = 3 right of
it) seen by four cameras 0.05 apart in x, so the step edge and the parts
of one plane hidden in other views fail the consistency tests; one view
carries depth noise and every view some pixels below the confidence
threshold. The fused point sets of the ``normal``, ``dynamic`` and
``gipuma`` backends must equal the JAX package's: the same count, the
coordinates within ``POINT_ATOL`` = 1e-5 (``tests/torch_mvs_tol.py``), the
colours and counts equal. The codecs (PLY, ``.dmb``) must write the same
bytes.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from diner_tpu.fusion import consistency as jcons
from diner_tpu.fusion import fusion as jfusion
from diner_tpu_torch.data.io import write_pfm
from diner_tpu_torch.fusion import consistency as pcons
from diner_tpu_torch.fusion import fusion as pfusion
from diner_tpu_torch.mvs import evaluate as pevaluate
from tests.torch_mvs_tol import POINT_ATOL

ROOT = Path(__file__).resolve().parents[1]
H, W, V = 48, 64, 4


def two_plane_scene(seed=0):
    """(depths, confidences, Ks, Es, images, pairs) of the scene above."""
    rng = np.random.RandomState(seed)
    f = 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    u = np.arange(W, dtype=np.float64) + 0.0
    depths, confs, Es, images = [], [], [], []
    for v in range(V):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = -0.05 * v  # camera centre at x = 0.05 v
        x_at_2 = 0.05 * v + (u - W / 2) / f * 2.0
        row = np.where(x_at_2 < 0, 2.0, 3.0).astype(np.float32)
        d = np.tile(row, (H, 1))
        if v == 2:
            d = d + (0.02 * rng.randn(H, W)).astype(np.float32)
        depths.append(d.astype(np.float32))
        confs.append(rng.uniform(0.5, 1.0, (H, W)).astype(np.float32))
        Es.append(E)
        images.append(rng.rand(H, W, 3).astype(np.float32))
    pairs = [(r, [s for s in range(V) if s != r]) for r in range(V)]
    return depths, confs, [K] * V, Es, images, pairs


def in_order(pts):
    """Rows sorted by every column, last key first: the C++ core appends
    points from OpenMP threads, so their order varies from run to run."""
    return pts[np.lexsort(pts.T[::-1])]


def assert_same_points(got, ref):
    assert got.shape == ref.shape and len(got) > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=POINT_ATOL)


@pytest.mark.parametrize("backend", ["normal", "dynamic"])
def test_consistency_backends_match_jax(backend):
    depths, confs, Ks, Es, images, pairs = two_plane_scene()
    if backend == "normal":
        kw = dict(images=images, conf_thresh=0.7, thres_view=2)
        got = pcons.filter_and_fuse(depths, confs, Ks, Es, pairs, **kw)
        ref = jcons.filter_and_fuse(depths, confs, Ks, Es, pairs, **kw)
    else:
        kw = dict(images=images, photo_threshold=0.7, thres_view=3)
        got = pcons.filter_and_fuse_dynamic(depths, confs, Ks, Es, pairs,
                                            **kw)
        ref = jcons.filter_and_fuse_dynamic(depths, confs, Ks, Es, pairs,
                                            **kw)
    kept = sum(int(m.sum()) for m in ref[2])
    assert 0.2 * V * H * W < kept < 0.9 * V * H * W  # the filters bite
    assert_same_points(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


def test_gipuma_fusion_matches_jax():
    depths, confs, Ks, Es, images, _ = two_plane_scene()
    d = np.stack([pfusion.probability_filter(a, c, 0.7)
                  for a, c in zip(depths, confs)])
    np.testing.assert_array_equal(
        d, np.stack([jfusion.probability_filter(a, c, 0.7)
                     for a, c in zip(depths, confs)]))
    normals = np.stack([pfusion.fake_normals(a) for a in d])
    np.testing.assert_array_equal(
        normals, np.stack([jfusion.fake_normals(a) for a in d]))
    P = np.stack([(K @ E[:3]).astype(np.float32) for K, E in zip(Ks, Es)])
    focals = np.asarray([K[0, 0] for K in Ks], np.float32)
    args = (d, normals, P, focals, np.stack(images))
    got = pfusion.fuse_depth_maps(*args, num_consistent=2)
    ref = jfusion.fuse_depth_maps(*args, num_consistent=2)
    assert 0 < len(ref) < V * H * W
    assert_same_points(in_order(got), in_order(ref))


def test_codecs_write_the_jax_bytes(tmp_path):
    rng = np.random.RandomState(3)
    pts = rng.rand(50, 10).astype(np.float32)
    for kw in (dict(), dict(with_normals=False),
               dict(with_normals=False, with_colors=False)):
        pfusion.write_ply(tmp_path / "p.ply", pts, **kw)
        jfusion.write_ply(tmp_path / "j.ply", pts, **kw)
        assert (tmp_path / "p.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
        names, floats, colors = pfusion.read_ply(tmp_path / "p.ply")
        cols = [0, 1, 2] + ([] if "with_normals" in kw else [3, 4, 5])
        np.testing.assert_array_equal(floats, pts[:, cols])
        assert (colors is None) == (kw.get("with_colors") is False)
    for img in (rng.rand(7, 9).astype(np.float32),
                rng.rand(7, 9, 3).astype(np.float32)):
        pfusion.write_gipuma_dmb(tmp_path / "p.dmb", img)
        jfusion.write_gipuma_dmb(tmp_path / "j.dmb", img)
        assert (tmp_path / "p.dmb").read_bytes() == \
            (tmp_path / "j.dmb").read_bytes()
        np.testing.assert_array_equal(
            pfusion.read_gipuma_dmb(tmp_path / "p.dmb"), img)


def test_library_builds_into_build_dir(tmp_path, monkeypatch):
    """The library is built from the port's copy of ``fusion.cpp`` into
    the git-ignored ``build/fusion/``, named by a hash of source and flags;
    a source that does not compile raises."""
    lib = pfusion.build_library()
    assert lib.exists() and lib.parent == ROOT / "build" / "fusion"
    assert pfusion.SRC == ROOT / "diner_tpu_torch/fusion/src/fusion.cpp"
    bad = tmp_path / "fusion.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pfusion, "SRC", bad)
    monkeypatch.setattr(pfusion, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fusion.cpp"):
        pfusion.build_library()


def write_protocol(out_root, testpath, scene):
    """The test CLI's folder protocol for ``scene`` under ``out_root``
    (depth_est, confidence, cams, images) and ``testpath``'s pair.txt."""
    depths, confs, Ks, Es, images, pairs = scene
    scan_out = out_root / "scan1"
    for sub in ("depth_est", "confidence", "cams", "images"):
        (scan_out / sub).mkdir(parents=True)
    for vid in range(V):
        write_pfm(scan_out / "depth_est" / f"{vid:08d}.pfm", depths[vid])
        write_pfm(scan_out / "confidence" / f"{vid:08d}.pfm", confs[vid])
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = Es[vid]
        cam[1, :3, :3] = Ks[vid]
        pevaluate.write_cam(scan_out / "cams" / f"{vid:08d}_cam.txt", cam,
                            1.5, 0.01)
        Image.fromarray((images[vid] * 255).astype(np.uint8)).save(
            scan_out / "images" / f"{vid:08d}.jpg")
    lines = [str(len(pairs))]
    for r, srcs in pairs:
        lines += [str(r), " ".join([str(len(srcs))]
                                   + [f"{s} {10.0 - s}" for s in srcs])]
    (testpath / "scan1").mkdir(parents=True)
    (testpath / "scan1" / "pair.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("method", ["normal", "dynamic", "gipuma"])
def test_evaluate_fuse_scan_matches_jax_script(tmp_path, method):
    """The CLI's ``fuse_scan`` on a folder in the test protocol writes the
    PLY that ``scripts/mvs_test.py``'s ``_fuse_scan`` writes from the same
    folder: the same header and the same points and colours (in the same
    order but for gipuma's, whose threads append them in any order)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import mvs_test
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    testpath = tmp_path / "scenes"
    write_protocol(tmp_path / "out", testpath, two_plane_scene(seed=1))
    args = types.SimpleNamespace(testpath=str(testpath), filter_method=method,
                                 conf=0.7, thres_view=2)
    res = pevaluate.fuse_scan(args, "scan1", tmp_path / "out")
    ply = tmp_path / "out" / "mvsnet_scan1.ply"
    got = pfusion.read_ply(ply)
    mvs_test._fuse_scan(args, "scan1", tmp_path / "out")
    ref = pfusion.read_ply(ply)
    assert res["ply"] == str(ply) and 0 < res["points"] < V * H * W
    assert got[0] == ref[0] and len(got[1]) == res["points"]
    rows = [np.concatenate([f, c.astype(np.float32)], axis=1)
            for _, f, c in (got, ref)]
    if method == "gipuma":
        rows = [in_order(r) for r in rows]
    np.testing.assert_array_equal(rows[0], rows[1])
