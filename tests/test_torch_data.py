"""Port parity of the data layer: the loader, the sphere dataset, the DTU
dataset and the image / depth codecs.

Each port module gets the same inputs as its JAX-package counterpart (the
same dataset, seed and files on disk) and must give identical outputs:
every batch, sample and array is compared exactly (all of it is host-side
numpy, PIL and scipy code run the same way in both packages).
"""

import numpy as np
import pytest

from diner_tpu.data import dtu as j_dtu
from diner_tpu.data import io as j_io
from diner_tpu.data.loader import DataLoader as JDataLoader
from diner_tpu.data.loader import collate as j_collate
from diner_tpu.data.synthetic_dataset import SphereDataset as JSphereDataset
from diner_tpu_torch.data import dtu as t_dtu
from diner_tpu_torch.data import io as t_io
from diner_tpu_torch.data.loader import DataLoader, collate
from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from test_data import _write_dtu_fixture


def assert_same(a, b):
    """Exact equality of nested dicts / lists of arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


class _Toy:
    """Samples of every kind ``collate`` handles: arrays, ints, floats,
    names and a nested dict."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return {"x": rng.rand(3, 2).astype(np.float32), "i": i,
                "f": float(i) / 3, "name": f"s{i}",
                "nested": {"y": np.full((2,), i, np.int64)}}


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=3, num_workers=0),
    dict(batch_size=4, shuffle=True, seed=3, num_workers=2),
    dict(batch_size=3, shuffle=False, drop_last=True, num_workers=0),
    dict(batch_size=2, shuffle=True, seed=0, num_workers=1,
         sample_indices=[7, 1, 4, 9, 2]),
], ids=["shuffle", "shuffle_threads", "drop_last", "sample_indices"])
def test_loader_matches_jax(kw):
    ours, ref = DataLoader(_Toy(), **kw), JDataLoader(_Toy(), **kw)
    assert len(ours) == len(ref)
    for _ in range(3):  # three epochs: each reshuffled by seed + epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert_same(a, b)
    samples = [_Toy()[i] for i in (0, 5)]
    assert_same(collate(samples), j_collate(samples))


def test_loader_surfaces_worker_errors():
    class Broken(_Toy):
        def __getitem__(self, i):
            raise OSError(f"cannot decode {i}")

    with pytest.raises(OSError, match="cannot decode"):
        list(DataLoader(Broken(), batch_size=2, num_workers=1))


@pytest.mark.parametrize("stage", ["train", "val"])
def test_sphere_dataset_matches_jax(stage):
    kw = dict(stage=stage, n=5, H=20, W=24, nv=3)
    ours, ref = SphereDataset(**kw), JSphereDataset(**kw)
    assert len(ours) == len(ref) == 5
    assert (ours.znear, ours.zfar) == (ref.znear, ref.zfar)
    for i in (0, 3):
        assert_same(ours[i], ref[i])
    # batches of the JAX loader's collation are the same too
    assert_same(next(iter(DataLoader(ours, 2, num_workers=0))),
                next(iter(JDataLoader(ref, 2, num_workers=0))))


def test_sphere_dataset_refuses_other_schemas():
    with pytest.raises(NotImplementedError, match="no IBRNet schema"):
        SphereDataset(model="IBRNet")


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dtu")
    root = tmp / "DTU"
    root.mkdir()
    _write_dtu_fixture(root)
    splits = tmp / "splits"
    splits.mkdir()
    for stage in ("train", "val"):
        (splits / f"dtu_{stage}_all.txt").write_text("scan1\n")
    return root, splits


@pytest.mark.parametrize("kw", [{}, {"exclude_cams": [3, 5]},
                                {"only_cams": [0, 12]}],
                         ids=["all", "exclude_cams", "only_cams"])
def test_dtu_dataset_matches_jax(dtu_root, kw):
    root, splits = dtu_root
    ours = t_dtu.DTUDataset(root, "train", split_dir=splits, **kw)
    ref = j_dtu.DTUDataset(root, "train", split_dir=splits, **kw)
    assert len(ours) == len(ref)
    assert (ours.znear, ours.zfar) == (ref.znear, ref.zfar)
    assert ours.metas == ref.metas
    assert_same(ours.cam_dict, ref.cam_dict)
    assert [ours.sample_name_of(i) for i in range(len(ours))] == \
        [ref.sample_name_of(i) for i in range(len(ref))]
    assert_same(ours[0], ref[0])  # images, depths, stds, cameras, names
    ours.check_depth_existence()
    np.testing.assert_array_equal(ours.get_cam_sweep_extrinsics(5),
                                  ref.get_cam_sweep_extrinsics(5))


def test_train_dtu_yaml_module_resolves(dtu_root):
    """configs/train_dtu.yaml names ``src.data.dtu.DTUDataSet``: the port's
    registry builds its DTUDataset from it, as the JAX package's does."""
    from diner_tpu.train.config import build_dataset as j_build
    from diner_tpu_torch.train.config import build_dataset
    root, splits = dtu_root
    conf = {"module": "src.data.dtu.DTUDataSet",
            "kwargs": {"root": str(root), "depth_fname": "TransMVSNet",
                       "split_dir": str(splits)}}
    ours, ref = build_dataset(conf, "train"), j_build(conf, "train")
    assert isinstance(ours, t_dtu.DTUDataset)
    assert len(ours) == len(ref) and ours.metas == ref.metas


def test_dtu_constants_and_shipped_splits():
    assert t_dtu.DTU_SCALE_FACTOR == j_dtu.DTU_SCALE_FACTOR
    assert t_dtu.SRC_CAM_IDCS == j_dtu.SRC_CAM_IDCS
    assert t_dtu.N_LIGHTS == j_dtu.N_LIGHTS
    for stage in ("train", "val"):
        name = f"dtu_{stage}_all.txt"
        assert (t_dtu._SPLIT_DIR / name).read_text() == \
            (j_dtu._SPLIT_DIR / name).read_text()
    np.testing.assert_array_equal(t_dtu.conf2std(np.linspace(0, 1, 7)),
                                  j_dtu.conf2std(np.linspace(0, 1, 7)))


def test_io_codecs_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    for shape in ((9, 13), (9, 13, 3)):
        img = rng.rand(*shape).astype(np.float32) * 5
        t_io.write_pfm(tmp_path / "a.pfm", img)
        j_io.write_pfm(tmp_path / "b.pfm", img)
        assert (tmp_path / "a.pfm").read_bytes() == \
            (tmp_path / "b.pfm").read_bytes()
        got, scale = t_io.read_pfm(tmp_path / "b.pfm")
        want, j_scale = j_io.read_pfm(tmp_path / "b.pfm")
        np.testing.assert_array_equal(got, want)
        assert scale == j_scale
    depth = rng.rand(16, 20).astype(np.float32) * 3
    t_io.write_depth_png(tmp_path / "d.png", depth)
    np.testing.assert_array_equal(t_io.read_depth_png(tmp_path / "d.png"),
                                  j_io.read_depth_png(tmp_path / "d.png"))
    from PIL import Image
    rgb = (rng.rand(30, 40, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "c.png")
    for down in (None, 0.5):
        np.testing.assert_array_equal(
            t_io.read_rgb(tmp_path / "c.png", down),
            j_io.read_rgb(tmp_path / "c.png", down))
    img = rng.rand(15, 21, 2).astype(np.float32)
    for h, w in ((7, 10), (31, 40)):
        np.testing.assert_array_equal(t_io.resize_nearest(img, h, w),
                                      j_io.resize_nearest(img, h, w))
        np.testing.assert_array_equal(t_io.resize_bilinear(img, h, w),
                                      j_io.resize_bilinear(img, h, w))
