"""The port's multiface path (``data/multiface.py``, ``geometry/cam_paths.py``,
``mvs/multiface_dataset.py``, ``data/debug.py``, ``--dataset multiface`` of
``python -m diner_tpu_torch.mvs``) against the JAX package's on the CPU.

Mirrors ``tests/test_multiface.py``, ``tests/test_mvs_multiface.py`` and
``tests/test_debug_harness.py`` on the same fabricated trees, and holds the
loaders against JAX's on one tree: metas, every sample (dtypes included)
and the sweep extrinsics equal.
"""

import json

import numpy as np
import pytest
import torch

from diner_tpu.data.multiface import MultifaceDataset as JMultiface
from diner_tpu.mvs.multiface_dataset import MVSMultifaceDataset as JMVS
from diner_tpu_torch.data.multiface import (
    MultifaceDataset,
    gamma_correct,
    load_krt,
)
from diner_tpu_torch.geometry.cam_paths import (
    TransSlerp,
    get_ray_intersections,
    interpolate_poses,
    pose_spherical,
)
from diner_tpu_torch.mvs.multiface_dataset import (
    MVSMultifaceDataset,
    build_multiface_mvs_metas,
)
from tests.test_data import _write_dtu_fixture, _write_facescape_fixture
from tests.test_multiface import (
    _krt_text,
    _ring_cameras,
    _write_multiface_fixture,
)
from tests.test_mvs_multiface import _four_center_split
from tests.test_torch_mvs_data import assert_same_sample


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers at once on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------- mirrors of test_multiface

def test_gamma_correct_matches_reference_formula():
    from diner_tpu.data.multiface import gamma_correct as j_gamma
    img = np.array([[[0.1, 0.5, 0.9]]], np.float32)
    out = gamma_correct(img)
    scale = np.array([1.4, 1.1, 1.6]) / 1.1
    expect = np.clip(
        ((1 / (1 - 3 / 255)) * 0.95 *
         np.clip(img * scale - 3 / 255, 0, 2)) ** 0.5 - 15 / 255, 0, 2)
    np.testing.assert_allclose(out, expect, atol=1e-6)
    np.testing.assert_array_equal(out, j_gamma(img))


def test_load_krt_roundtrip(tmp_path):
    cams = _ring_cameras(3)
    p = tmp_path / "KRT"
    p.write_text(_krt_text(cams))
    out = load_krt(p)
    assert set(out) == set(cams)
    for name in cams:
        np.testing.assert_allclose(out[name]["intrin"], cams[name][0],
                                   atol=1e-5)
        np.testing.assert_allclose(out[name]["extrin"], cams[name][1],
                                   atol=1e-5)


def test_multiface_dataset(tmp_path):
    root, split = _write_multiface_fixture(tmp_path)
    ds = MultifaceDataset(root, "train", split_config=split, downsample=2,
                          meta_dir=tmp_path / "meta_cache")
    assert len(ds) > 0
    s = ds[0]
    H, W = s["target_rgb"].shape[:2]
    assert H % 32 == 0 and W % 32 == 0
    assert s["src_rgbs"].shape[0] == len(ds.metas[0]["ref_ids"][2:])
    assert s["src_depths"].shape == s["src_depth_stds"].shape
    assert np.abs(s["src_extrinsics"][:, :3, 3]).max() < 10.0
    masked = s["target_rgb"][s["target_alpha"][..., 0] < 1]
    assert masked.mean() > 0.95
    valid = s["src_depths"] > 0
    np.testing.assert_allclose(s["src_depth_stds"][valid], 1e-3)
    ds2 = MultifaceDataset(root, "train", split_config=split, downsample=2,
                           meta_dir=tmp_path / "meta_cache")
    assert len(ds2) == len(ds)
    sweep = ds.get_cam_sweep_extrinsics(5, 0)
    assert sweep.shape == (5, 4, 4)
    for E in sweep:
        np.testing.assert_allclose(E[:3, :3] @ E[:3, :3].T, np.eye(3),
                                   atol=1e-5)


def test_cam_path_utils():
    from diner_tpu.geometry import cam_paths as j_paths
    ts = TransSlerp(np.array([0.0, 1.0]),
                    np.array([[1.0, 0, 0], [0, 1.0, 0]]))
    out = ts(np.array([-0.1, 0.0, 0.5, 1.0, 1.1]))
    np.testing.assert_allclose(out[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[2], [0.5, 0.5, 0], atol=1e-6)
    np.testing.assert_allclose(out[4], [0, 1, 0], atol=1e-6)
    p1, p2 = get_ray_intersections(np.array([1, 0, 0, -1, 0, 0.0]),
                                   np.array([0, -1, 0, 0, 1.0, 0]))
    np.testing.assert_allclose(p1, [0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(p2, [0, 0, 0], atol=1e-6)
    pose = pose_spherical(30.0, -20.0, 2.0)
    assert pose.shape == (4, 4)
    np.testing.assert_allclose(np.linalg.norm(pose[:3, 3]), 2.0, atol=1e-5)
    np.testing.assert_array_equal(pose, j_paths.pose_spherical(30.0, -20.0,
                                                               2.0))
    poses = np.stack([pose_spherical(a, -10.0, 2.0) for a in (0, 40, 90)])
    np.testing.assert_array_equal(interpolate_poses(poses, 7),
                                  j_paths.interpolate_poses(poses, 7))


# ------------------------------------------- mirrors of test_mvs_multiface

def test_build_multiface_mvs_metas_leave_one_out():
    diner_metas = [
        dict(scan_path="subj/images/SEQ1/camA/000001.png",
             target_id="camA", ref_ids=["c0", "c1", "c2", "c3"]),
        dict(scan_path="subj/images/SEQ1/camB/000001.png",
             target_id="camB", ref_ids=["c0", "c1", "c2", "c3"]),
        dict(scan_path="subj/images/SEQ1/camA/000002.png",
             target_id="camA", ref_ids=["c0", "c1", "c2", "c3"]),
    ]
    metas = build_multiface_mvs_metas(diner_metas, nviews=4)
    assert len(metas) == 8
    first = metas[:4]
    assert [m["target_ids"] for m in first] == ["c0", "c1", "c2", "c3"]
    assert first[1]["ref_ids"] == ["c0", "c2", "c3"]
    assert all(m["scan_path"].endswith("000001.png") for m in first)


def test_mvs_multiface_dataset(tmp_path):
    root, split = _write_multiface_fixture(tmp_path)
    _four_center_split(split)
    ds = MVSMultifaceDataset(root, "train", nviews=4, ndepths=32,
                             downsample_factor=0.5, split_config=split,
                             meta_dir=tmp_path / "mvs_meta")
    assert len(ds) % 4 == 0 and len(ds) > 0
    s = ds[0]
    V, H, W, C = s["imgs"].shape
    assert (V, C) == (4, 3)
    assert H % 32 == 0 and W % 32 == 0
    np.testing.assert_allclose(s["depth_values"][0], 0.5)
    np.testing.assert_allclose(s["depth_values"][-1], 1.5)
    np.testing.assert_allclose(s["depth_interval"], (1.5 - 0.5) / 31,
                               rtol=1e-6)
    assert s["depth"]["stage3"].shape == (H, W)
    assert s["depth"]["stage1"].shape == (H // 4, W // 4)
    assert s["mask"]["stage2"].shape == (H // 2, W // 2)
    p1 = s["proj_matrices"]["stage1"]
    p3 = s["proj_matrices"]["stage3"]
    np.testing.assert_allclose(p1[:, 1, 0, 0],
                               p3[:, 1, 0, 0] * ((W // 4) / W), rtol=1e-6)
    assert np.abs(p3[:, 0, :3, 3]).max() < 10.0
    m = s["mask"]["stage3"]
    assert s["imgs"][0][m < 1].mean() > 0.95
    assert s["dpath"].endswith("000001.png")
    targets = [ds.metas[i]["target_ids"] for i in range(4)]
    assert len(set(targets)) == 4


# ---------------------------------------- the loaders against JAX's

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiface")
    return tmp, *_write_multiface_fixture(tmp, H=64, W=96)


@pytest.mark.parametrize("stage,downsample", [("train", 2), ("val", 1)])
def test_multiface_dataset_matches_jax(tree, stage, downsample):
    """Metas (generated, then read from the cache), every sample and the
    sweep extrinsics equal JAX's; bilinear resizes at downsample 2."""
    tmp, root, split = tree
    kw = dict(split_config=split, downsample=downsample,
              meta_dir=tmp / f"cache_{stage}")
    ours = MultifaceDataset(root, stage, **kw)
    ref = JMultiface(root, stage, **kw)
    assert ours.metas == ref.metas and len(ours) >= 4
    assert MultifaceDataset(root, stage, **kw).metas == ref.metas  # cache
    for i in range(len(ours)):
        assert_same_sample(ours[i], ref[i], f"sample {i}")
    np.testing.assert_array_equal(ours.get_cam_sweep_extrinsics(6, 1),
                                  ref.get_cam_sweep_extrinsics(6, 1))
    filt = dict(kw, target_filter=[ref.metas[-1]["target_id"]],
                sequence_filter=["SEQ1"])
    assert MultifaceDataset(root, stage, **filt).metas == JMultiface(
        root, stage, **filt).metas


def test_mvs_multiface_dataset_matches_jax(tree):
    tmp, root, split = tree
    split4 = tmp / "split4.json"
    split4.write_text(split.read_text())
    _four_center_split(split4)
    kw = dict(nviews=4, ndepths=16, downsample_factor=0.5,
              split_config=split4)
    ours = MVSMultifaceDataset(root, "train", **kw)
    ref = JMVS(root, "train", **kw)
    assert ours.metas == ref.metas and len(ours) == 4
    for i in range(len(ours)):
        assert_same_sample(ours[i], ref[i], f"sample {i}")


def test_multiface_check_depth_existence(tree, tmp_path):
    tmp, root, split = tree
    ds = MultifaceDataset(root, "val", split_config=split, downsample=1)
    ds.check_depth_existence()
    victim = root / ds.metas[0]["scan_path"]
    subj, seq = victim.parents[3].name, victim.parents[1].name
    sid = ds.metas[0]["ref_ids"][2]
    dpath = root / subj / "depths" / seq / sid / "000001.png"
    moved = tmp_path / "moved.png"
    dpath.rename(moved)
    try:
        with pytest.raises(FileNotFoundError, match=sid):
            ds.check_depth_existence()
    finally:
        moved.rename(dpath)


def test_mvs_cli_trains_on_multiface(tmp_path, monkeypatch):
    """``python -m diner_tpu_torch.mvs --dataset multiface --mode train``
    at the CLI's own downsample (1/8: 512×768 images → 64×96) with a toy
    model: finite losses, no step skipped, a checkpoint."""
    import dataclasses

    from diner_tpu_torch.mvs import __main__ as mvs_cli
    full = mvs_cli.train_config
    monkeypatch.setattr(mvs_cli, "train_config", lambda a: dataclasses.replace(
        full(a), model=dataclasses.replace(full(a).model, base_channels=4,
                                           cr_base_chs=(4, 4, 4))))
    root, split = _write_multiface_fixture(tmp_path, H=512, W=768)
    _four_center_split(split)
    recs = mvs_cli.main(["--mode", "train", "--dataset", "multiface",
                         "--trainpath", str(root), "--split_config",
                         str(split),
                         "--ndepths", "8,8,8", "--numdepth", "48",
                         "--max-steps", "2", "--logdir", str(tmp_path / "run"),
                         "--device", "cpu"])
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0 for r in recs)
    assert (tmp_path / "run" / "checkpoints").is_dir()


# ----------------------------------------- mirrors of test_debug_harness

def test_facescape_debug_harness(tmp_path):
    from diner_tpu_torch.data.facescape import FacescapeDataset
    root, split_dir = _write_facescape_fixture(tmp_path)
    ds = FacescapeDataset(root, "val", split_dir=split_dir)
    out = tmp_path / "item.png"
    ds.visualize_item(0, show=False, outfile=out)
    assert out.exists() and out.stat().st_size > 0
    out2 = tmp_path / "grid.png"
    centers = ds.visualize_camgrid(0, show=False, outfile=out2)
    assert out2.exists() and centers.shape[1] == 3
    ds.check_depth_existence()
    pts = ds.reproject_depth(0, outfile=tmp_path / "cloud.txt")
    assert pts.shape[1] == 6 and len(pts) > 0
    assert (tmp_path / "cloud.txt").exists()
    s = ds[0]
    E = np.asarray(s["src_extrinsics"][0], np.float64)
    xyz_cam = (E @ np.concatenate(
        [pts[:, :3], np.ones((len(pts), 1))], -1).T)[:3].T
    assert (xyz_cam[:, 2] != 0).all()
    from diner_tpu.data.debug import reproject_depth as j_reproject
    np.testing.assert_array_equal(pts, j_reproject(s))


def test_facescape_check_depth_existence_raises(tmp_path):
    from diner_tpu_torch.data.facescape import FacescapeDataset
    root, split_dir = _write_facescape_fixture(tmp_path)
    ds = FacescapeDataset(root, "val", split_dir=split_dir)
    victim = next(root.rglob("depth_gt_pred_conf.png"))
    victim.unlink()
    with pytest.raises(FileNotFoundError) as e:
        ds.check_depth_existence()
    assert "depth_gt_pred_conf" in str(e.value)


def test_dtu_debug_harness(tmp_path):
    from diner_tpu_torch.data.dtu import DTUDataset
    root = tmp_path / "DTU"
    root.mkdir()
    _write_dtu_fixture(root)
    split_dir = tmp_path / "splits"
    split_dir.mkdir()
    (split_dir / "dtu_train_all.txt").write_text("scan1\n")
    ds = DTUDataset(root, "train", split_dir=split_dir)
    out = tmp_path / "dtu_grid.png"
    centers = ds.visualize_camgrid(show=False, outfile=out)
    assert out.exists() and len(centers) == len(ds.cam_dict["ids"])
    out2 = tmp_path / "dtu_item.png"
    ds.visualize_item(0, show=False, outfile=out2)
    assert out2.exists()


def test_debug_camera_centers_match_jax():
    from diner_tpu.data.debug import camera_centers as j_centers
    from diner_tpu_torch.data.debug import camera_centers
    E = np.stack([np.hstack([c[1], np.zeros((3, 0))])
                  for c in _ring_cameras(5).values()])
    np.testing.assert_array_equal(camera_centers(E), j_centers(E))
    np.testing.assert_allclose(np.linalg.norm(
        camera_centers(E) - [0, 0, 1000.0], axis=-1)[0], 900 * np.sqrt(1.01))
    assert json.dumps(camera_centers(E).tolist())
