"""Port parity for the FaceScape datasets: ``FacescapeDataset`` (DINER and
KeypointNeRF schemas, the depth variants, the camera sweep),
``FacescapeNovelDataset`` (cross-expression pairs, meshes, PE maps, the
side-tree lookup) and ``FacescapeRegressorDataset``, sample for sample
against the JAX package's on a fixture this file writes (the
``tests/test_data.py`` FaceScape scan plus a second expression, meshes,
landmarks, PE maps and a canonical "gen" subject), and their registry
names. Validation samples use both packages' seeded RNG (128); training
samples, whose RNG is unseeded in both, get the same injected generator.
Samples must be equal: same keys, dtypes and values.
"""

import json
import shutil

import numpy as np
import pytest
from PIL import Image

from diner_tpu.data import facescape as jfs
from diner_tpu.data import facescape_novel as jfsn
from diner_tpu.data import facescape_regressor as jfsr
from diner_tpu_torch.data import facescape as tfs
from diner_tpu_torch.data import facescape_novel as tfsn
from diner_tpu_torch.data import facescape_regressor as tfsr
from diner_tpu_torch.train.config import build_dataset
from test_data import _write_facescape_fixture

N_VERTS = 40


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        if isinstance(v, np.ndarray):
            assert isinstance(a[k], np.ndarray) and a[k].dtype == v.dtype, k
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            assert a[k] == v, k


def _write_mesh(scan, rng):
    np.savetxt(scan / "face_vertices.npy",
               rng.normal(0, 0.1, (N_VERTS, 3)) + [0, 0, 2.0])
    np.savetxt(scan / "3dlmks.npy", rng.normal(0, 0.1, (8, 3)) + [0, 0, 2])


def _write_pe(vdir, rng, H=64, W=64):
    Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
        vdir / "pos_encoding.png")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The binocular fixture of tests/test_data.py, extended: a second
    expression (frame002) of the subject, meshes and landmarks, PE maps
    beside every view, the canonical subject 002/03 with camera 18, the
    novel metas, and a flat side tree holding the same PE maps and mesh
    depths under the fork's names."""
    tmp = tmp_path_factory.mktemp("fs")
    root, split_dir = _write_facescape_fixture(tmp)
    rng = np.random.RandomState(11)
    frame1 = root / "subj01" / "frame001"
    frame2 = root / "subj01" / "frame002"
    shutil.copytree(frame1, frame2)
    gen = root / "002" / "03"
    (gen / "view_00018").mkdir(parents=True)
    cams = json.loads((frame1 / "cameras.json").read_text())
    (gen / "cameras.json").write_text(json.dumps({"18": cams["2"]}))
    for scan in (frame1, frame2, gen):
        _write_mesh(scan, rng)
        for vdir in sorted(scan.glob("view_*")):
            _write_pe(vdir, rng)
    novel = [{"ref_scan_path": "subj01/frame001",
              "target_scan_path": "subj01/frame002",
              "targets": ["1", "2"], "l_refs": ["2"], "r_refs": ["3", "1"]},
             {"ref_scan_path": "subj01/frame002",
              "target_scan_path": "subj01/frame001",
              "targets": ["3"], "l_refs": ["1", "2"], "r_refs": ["3"]}]
    for stage in ("train", "val"):
        (split_dir / f"{stage}_metas_novel.txt").write_text(json.dumps(novel))
    side = tmp / "side"
    for kind, src_name, rels in (
            ("target_pos_encodings", "pos_encoding.png",
             ["subj01/frame001", "subj01/frame002", "002/03"]),
            ("ref_pos_encodings", "pos_encoding.png",
             ["subj01/frame001", "subj01/frame002"]),
            ("depths_mesh", "depth_mesh.png",
             ["subj01/frame001", "subj01/frame002"])):
        (side / kind).mkdir(parents=True)
        for rel in rels:
            for vdir in sorted((root / rel).glob("view_*")):
                flat = "_".join(f"{rel}/{vdir.name}/{src_name}".split("/"))
                shutil.copy(vdir / src_name, side / kind / flat)
    return root, split_dir, side


# ------------------------------------------------------------------ helpers

def test_helpers_match_jax(tree):
    root, _, _ = tree
    vdir = root / "subj01" / "frame001" / "view_00002"
    x = np.linspace(0, 1, 7, dtype=np.float32)
    np.testing.assert_array_equal(tfs.conf2std(x), jfs.conf2std(x))
    t = np.arange(2 * 12, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(tfs.to_homogeneous(t),
                                  jfs.to_homogeneous(t))
    for a, b in zip(tfs.read_rgba(vdir / tfs.RGBA_FNAME),
                    jfs.read_rgba(vdir / jfs.RGBA_FNAME)):
        np.testing.assert_array_equal(a, b)
    for kind in ("original", "mesh", "merge"):
        for a, b in zip(
                tfs.read_depth_triptych(vdir / tfs.DEPTH_FNAME,
                                        vdir / tfs.DEPTH_MESH_FNAME, kind),
                jfs.read_depth_triptych(vdir / jfs.DEPTH_FNAME,
                                        vdir / jfs.DEPTH_MESH_FNAME, kind)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tfs.read_depth_triptych(vdir / tfs.DEPTH_FNAME,
                                vdir / tfs.DEPTH_MESH_FNAME, "nope")
    scan = root / "subj01" / "frame001"
    bounds = tfs.load_face_bounds(scan)
    np.testing.assert_array_equal(bounds, jfs.load_face_bounds(scan))
    K = np.array([[50.0, 0, 32], [0, 50, 32], [0, 0, 1]], np.float32)
    R, T = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    mask = tfs.get_mask_at_box(bounds, K, R, T, 64, 64)
    np.testing.assert_array_equal(
        mask, jfs.get_mask_at_box(bounds, K, R, T, 64, 64))
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(
        tfsn.read_pos_encoding(vdir / "pos_encoding.png"),
        jfsn.read_pos_encoding(vdir / "pos_encoding.png"))
    for a, b in zip(tfsn.read_mesh_depth(vdir / "depth_mesh.png"),
                    jfsn.read_mesh_depth(vdir / "depth_mesh.png")):
        np.testing.assert_array_equal(a, b)
    v = np.loadtxt(scan / "face_vertices.npy", dtype=np.float32)
    extr = tfs.to_homogeneous(np.hstack([np.eye(3), [[0], [0], [1.0]]])
                              .astype(np.float32))
    np.testing.assert_array_equal(tfsr.project_vertices(v, extr, K),
                                  jfsr.project_vertices(v, extr, K))


# ------------------------------------------------------- FacescapeDataset

@pytest.mark.parametrize("model", ["DINER", "KeypointNeRF"])
@pytest.mark.parametrize("depth_type", ["original", "merge"])
def test_facescape_dataset_matches_jax(tree, model, depth_type):
    root, split_dir, _ = tree
    kw = dict(split_dir=split_dir, model=model, depth_type=depth_type)
    for stage in ("val", "train"):
        ours = tfs.FacescapeDataset(root, stage, **kw)
        ref = jfs.FacescapeDataset(root, stage, **kw)
        if stage == "train":  # unseeded in both packages: inject one
            ours.rnd = np.random.default_rng(5)
            ref.rnd = np.random.default_rng(5)
        assert len(ours) == len(ref) == (20 if stage == "val" else 5)
        for i in range(3):
            _assert_same(ours[i], ref[i])
    s = ours[0]
    if model == "DINER":
        assert s["src_depths"].shape == (2, 64, 64, 1)
    else:
        assert s["mask_at_box"].shape == (64, 64)


def test_facescape_depth_root_and_sweep_match_jax(tree, tmp_path):
    root, split_dir, _ = tree
    # the fork's flat depth side tree
    depth_root = tmp_path / "depths"
    for kind, name in (("depths_gt_pred_conf", tfs.DEPTH_FNAME),
                       ("depths_mesh", tfs.DEPTH_MESH_FNAME)):
        (depth_root / kind).mkdir(parents=True)
        for vdir in (root / "subj01" / "frame001").glob("view_*"):
            flat = "_".join(f"subj01/frame001/{vdir.name}/{name}".split("/"))
            shutil.copy(vdir / name, depth_root / kind / flat)
    kw = dict(split_dir=split_dir, depth_root=depth_root, depth_type="mesh")
    ours = tfs.FacescapeDataset(root, "val", **kw)
    ref = jfs.FacescapeDataset(root, "val", **kw)
    _assert_same(ours[0], ref[0])
    # the sweep, with the off-axis rig of tests/test_data.py (the
    # fixture's cameras sit on the sweep's singular z axis)
    ours = _off_axis(tfs.FacescapeDataset)(root, "val", split_dir=split_dir)
    ref = _off_axis(jfs.FacescapeDataset)(root, "val", split_dir=split_dir)
    got = ours.get_cam_sweep_extrinsics(5, 0, radius=1.7, sweep_range=30.0)
    assert got.shape == (5, 4, 4) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, ref.get_cam_sweep_extrinsics(5, 0, radius=1.7,
                                          sweep_range=30.0),
        rtol=0, atol=1e-6)


def _off_axis(cls):
    class OffAxis(cls):
        def __getitem__(self, idx):
            s = super().__getitem__(idx)
            extr = []
            for ang in (-0.3, 0.3):
                R = np.array([[np.cos(ang), -np.sin(ang), 0],
                              [np.sin(ang), np.cos(ang), 0],
                              [0, 0, 1.0]])
                E = np.eye(4)
                E[:3, :3] = R
                E[:3, 3] = -R @ (R @ np.array([0.0, -1.6, 0.2]))
                extr.append(E)
            s["src_extrinsics"] = np.stack(extr).astype(np.float32)
            return s
    return OffAxis


# --------------------------------------------------- FacescapeNovelDataset

@pytest.mark.parametrize("side", [False, True])
def test_facescape_novel_dataset_matches_jax(tree, side):
    root, split_dir, side_root = tree
    kw = dict(split_dir=split_dir, side_root=side_root if side else None)
    for stage in ("val", "train"):
        ours = tfsn.FacescapeNovelDataset(root, stage, **kw)
        ref = jfsn.FacescapeNovelDataset(root, stage, **kw)
        if stage == "train":
            ours.rnd = np.random.default_rng(6)
            ref.rnd = np.random.default_rng(6)
        assert len(ours) == len(ref) == (40 if stage == "val" else 10)
        for i in (0, 1, len(ref) - 1):
            _assert_same(ours[i], ref[i])
    s = ours[0]
    assert s["target_vertices"].shape == (N_VERTS, 3)
    np.testing.assert_array_equal(
        s["offset_target_to_source"],
        s["src_vertices"] - s["target_vertices"])
    assert s["src_pos_encodings"].shape == (2, 64, 64, 3)
    assert np.abs(s["offset_target_to_gen"]).max() > 0


# ----------------------------------------------- FacescapeRegressorDataset

def test_facescape_regressor_dataset_matches_jax(tree):
    root, split_dir, _ = tree
    for stage in ("val", "train"):
        ours = tfsr.FacescapeRegressorDataset(root, stage,
                                              split_dir=split_dir)
        ref = jfsr.FacescapeRegressorDataset(root, stage,
                                             split_dir=split_dir)
        if stage == "train":
            ours.rnd = np.random.default_rng(7)
            ref.rnd = np.random.default_rng(7)
        assert len(ours) == len(ref)
        for i in range(2):
            _assert_same(ours[i], ref[i])
    assert ours[0]["target_keypoints"].shape == (N_VERTS, 2)


# ------------------------------------------------------------ the registry

@pytest.mark.parametrize("module,cls,model", [
    ("facescape", tfs.FacescapeDataset, "DINER"),
    ("src.data.facescape.FacescapeDataSet", tfs.FacescapeDataset,
     "KeypointNeRF"),
    ("facescape_novel", tfsn.FacescapeNovelDataset, "NOVEL"),
    ("src.data.facescape_novel.FacescapeDataSet", tfsn.FacescapeNovelDataset,
     "NOVEL_PE"),
    ("facescape_regressor", tfsr.FacescapeRegressorDataset, "DINER"),
    ("src.data.facescape_regressor.FacescapeDataSet",
     tfsr.FacescapeRegressorDataset, "NOVEL")])
def test_registry_builds_facescape_datasets(tree, module, cls, model):
    root, split_dir, _ = tree
    ds = build_dataset({"module": module, "kwargs": {
        "root": str(root), "split_dir": str(split_dir)}}, "val", model)
    assert type(ds) is cls and len(ds) > 0
    if hasattr(ds, "model"):
        assert ds.model == model
