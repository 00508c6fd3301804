"""The MVS port's data layer and CLIs against the JAX package, on the CPU:
``MVSDTUDataset`` and ``MVSGeneralEvalDataset`` (with their preprocessing
helpers) on fabricated trees built as ``tests/test_mvs_train.py`` and
``tests/test_mvs_eval_datasets.py`` build theirs, the DTU fixture writer
against ``scripts/make_dtu_fixture.py``, ``python -m diner_tpu_torch.mvs``
(write_prediction, val, multiface without its split json) and ``python -m
diner_tpu_torch.mvs.evaluate --device cpu`` against the folder protocol of
``scripts/mvs_test.py``.

Tolerances (``tests/torch_mvs_tol.py``): the datasets and the fixture are
host numpy copies, so their samples must be equal, not close; a depth PNG
the CLI writes is within ``PNG_LSB`` = 1 unit of the model's depth run
directly. The CLIs run the model at 64×96 (``prepare_img`` cut to the
centre of its crop; TransMVSNet needs H and W divisible by 32) with
ndepths (8, 8, 8): the network's parity with the JAX package is
``tests/test_torch_mvs_model.py``'s.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diner_tpu.data.io import write_pfm
from diner_tpu.mvs import datasets as jdatasets
from diner_tpu.mvs import eval_datasets as jeval
from diner_tpu_torch.data import dtu_fixture
from diner_tpu_torch.data.io import read_depth_png, read_pfm
from diner_tpu_torch.fusion.fusion import read_ply
from diner_tpu_torch.mvs import __main__ as mvs_cli
from diner_tpu_torch.mvs import datasets as pdatasets
from diner_tpu_torch.mvs import eval_datasets as peval
from diner_tpu_torch.mvs import evaluate as pevaluate
from diner_tpu_torch.mvs import predict
from tests.torch_mvs_tol import PNG_LSB

ROOT = Path(__file__).resolve().parents[1]
SMALL_CFG = ["--ndepths", "8,8,8", "--numdepth", "48"]


def assert_same_sample(got, ref, path=""):
    """Every entry of two dataset samples equal (nested dicts, arrays,
    strings), dtypes included."""
    assert sorted(got) == sorted(ref), path
    for k in ref:
        a, b = got[k], ref[k]
        if isinstance(b, dict):
            assert_same_sample(a, b, f"{path}/{k}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(a, b, err_msg=f"{path}/{k}")
        else:
            assert a == b, f"{path}/{k}"


def import_script(name):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT / "scripts"))


# ------------------------------------------------------------ DTU (yao)

@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    """The quad grid's 4 corner views of one scan (light 3), 1200×1600,
    random images and depths, as ``tests/test_mvs_train.py`` writes them
    → (root, list file)."""
    root = tmp_path_factory.mktemp("mvs_dtu")
    rng = np.random.RandomState(0)
    (root / "Cameras/train").mkdir(parents=True)
    for i in range(49):
        K = np.array([[45.0, 0, 80.0], [0, 45.0, 64.0], [0, 0, 1]])
        E = np.eye(4)
        E[:3, 3] = [2.0 * (i % 7 - 3), 1.5 * (i // 7 - 3), 0]
        lines = ["extrinsic"]
        lines += [" ".join(f"{v:.6f}" for v in row) for row in E]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{v:.6f}" for v in row) for row in K]
        lines += ["", "425.0 2.5"]
        (root / "Cameras/train" / f"{i:08d}_cam.txt").write_text(
            "\n".join(lines) + "\n")
    (root / "Rectified" / "scan1_train").mkdir(parents=True)
    (root / "Depths" / "scan1").mkdir(parents=True)
    for vid in (6, 10, 30, 35):
        img = (rng.rand(1200, 1600, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "Rectified" / "scan1_train" /
                                  f"rect_{vid + 1:03d}_3_r5000.png",
                                  compress_level=1)
        write_pfm(root / "Depths" / "scan1" / f"depth_map_{vid:04d}.pfm",
                  (rng.rand(1200, 1600) * 100 + 500).astype(np.float32))
        vis = (rng.rand(1200, 1600) * 255).astype(np.uint8)
        Image.fromarray(vis).save(root / "Depths" / "scan1" /
                                  f"depth_visual_{vid:04d}.png",
                                  compress_level=1)
    listfile = root / "list.txt"
    listfile.write_text("scan1\n")
    return root, listfile


def test_mvs_dtu_dataset_matches_jax(dtu_tree):
    """val mode: the 4 quad-grid corners (cameras 10, 30, 6 and 35, the
    source views DINER reads) are the targets, each sample equal to the
    JAX package's; the quad grid of train mode too."""
    root, listfile = dtu_tree
    got = pdatasets.MVSDTUDataset(root, listfile, "val", ndepths=48)
    ref = jdatasets.MVSDTUDataset(root, listfile, "val", ndepths=48)
    assert len(got) == len(ref) == 4
    assert sorted(m[2] for m in got.metas) == [6, 10, 30, 35]
    for i in range(4):
        assert_same_sample(got[i], ref[i], f"sample {i}")
    assert got[0]["imgs"].shape == (4, 512, 640, 3)
    train = pdatasets.MVSDTUDataset(root, listfile, "train")
    assert train.metas == jdatasets.MVSDTUDataset(root, listfile,
                                                  "train").metas
    assert pdatasets.quad_grid_ids(True) == jdatasets.quad_grid_ids(True)
    hr = np.random.RandomState(1).rand(1200, 1600, 3).astype(np.float32)
    np.testing.assert_array_equal(pdatasets.prepare_img(hr),
                                  jdatasets.prepare_img(hr))
    with pytest.raises(ValueError, match="4 views"):
        pdatasets.MVSDTUDataset(root, listfile, "val", nviews=3)


# ------------------------------------------------------ general eval set

def _write_cam(path, K, E, depth_line):
    lines = ["extrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in E]
    lines += ["", "intrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in K]
    lines += ["", depth_line]
    path.write_text("\n".join(lines) + "\n")


def general_eval_tree(root, depth_line="425.0 2.5", sizes=(600, 600, 600)):
    """One test-layout scan of 3 views (``images/``, ``cams/``,
    ``pair.txt``) with 800-wide images of the given heights → root."""
    scan = root / "scan1"
    (scan / "cams").mkdir(parents=True)
    (scan / "images").mkdir()
    pairs = [(0, [1, 2]), (1, [0, 2]), (2, [1])]
    lines = [str(len(pairs))]
    for ref, srcs in pairs:
        lines += [str(ref), " ".join([str(len(srcs))]
                                     + [f"{s} {100.0 - s}" for s in srcs])]
    (scan / "pair.txt").write_text("\n".join(lines) + "\n")
    rng = np.random.RandomState(0)
    K = np.array([[800.0, 0, 400], [0, 800, 300], [0, 0, 1]], np.float32)
    for vid, h in enumerate(sizes):
        E = np.eye(4, dtype=np.float32)
        E[0, 3] = 0.1 * vid
        _write_cam(scan / "cams" / f"{vid:08d}_cam.txt", K, E, depth_line)
        img = (rng.rand(h, 800, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(scan / "images" / f"{vid:08d}.jpg")
    return root


@pytest.mark.parametrize("depth_line,fix_res,sizes", [
    ("425.0 2.5", False, (600, 600, 600)),
    ("425.0 2.5 192", False, (600, 600, 600)),
    ("425.0 2.5", True, (600, 640, 560)),
    ("425.0 2.5", False, (600, 640, 560)),
])
def test_general_eval_dataset_matches_jax(tmp_path, depth_line, fix_res,
                                          sizes):
    """Every sample equal to the JAX package's: the base-32 fit, the
    interval from a 2- or 3-field depth line, views of another size
    resized to the reference view's or, with ``fix_res``, to the scene's
    first."""
    root = general_eval_tree(tmp_path, depth_line, sizes)
    kw = dict(nviews=3, ndepths=48, max_h=512, max_w=640, fix_res=fix_res)
    got = peval.MVSGeneralEvalDataset(root, ["scan1"], "test", **kw)
    ref = jeval.MVSGeneralEvalDataset(root, ["scan1"], "test", **kw)
    assert len(got) == len(ref) == 3
    for i in range(3):
        assert_same_sample(got[i], ref[i], f"sample {i}")
    with pytest.raises(ValueError, match="test-only"):
        peval.MVSGeneralEvalDataset(root, ["scan1"], "train", nviews=3)


def test_preprocess_helpers_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    K = np.array([[100.0, 0, 50], [0, 100, 40], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(peval.scale_camera(K, 0.37),
                                  jeval.scale_camera(K, 0.37))
    img = rng.rand(33, 45, 3).astype(np.float32)
    for interp in ("linear", "nearest"):
        np.testing.assert_array_equal(
            peval.scale_image(img, 0.61, interp),
            jeval.scale_image(img, 0.61, interp))
    imgs = [rng.rand(30, 42, 3).astype(np.float32) for _ in range(2)]
    depth = rng.rand(30, 42).astype(np.float32)
    for d in (None, depth):
        got = peval.scale_mvs_input(imgs, [K.copy(), K.copy()], d, 0.5, 2)
        ref = jeval.scale_mvs_input(imgs, [K.copy(), K.copy()], d, 0.5, 2)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    imgs = [rng.rand(33, 45, 3).astype(np.float32) for _ in range(2)]
    got = peval.crop_mvs_input(imgs, [K.copy(), K.copy()], depth[:33],
                               view_num=2, max_h=32, max_w=40)
    ref = jeval.crop_mvs_input(imgs, [K.copy(), K.copy()], depth[:33],
                               view_num=2, max_h=32, max_w=40)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = (rng.rand(8, 8, 3) * 10).astype(np.float32)
    np.testing.assert_array_equal(peval.center_img(x), jeval.center_img(x))
    proj = rng.rand(3, 2, 4, 4).astype(np.float32)
    assert_same_sample(peval._proj_pyramid(proj), jeval._proj_pyramid(proj))
    root = general_eval_tree(tmp_path)
    assert (peval.read_pair_file(root / "scan1" / "pair.txt")
            == jeval.read_pair_file(root / "scan1" / "pair.txt"))


# ------------------------------------------------------------- fixture

def test_dtu_fixture_matches_jax_script(tmp_path):
    """The port's fixture renders what ``scripts/make_dtu_fixture.py``
    renders (per-scan parameters, cameras, the ray-marched views), and
    ``--cams 24 --lights 2`` writes one camera's files, all 49 cam files
    and the list."""
    jfix = import_script("make_dtu_fixture")
    for k in range(3):
        assert dtu_fixture.scan_params(k) == jfix.scan_params(k)
    K = np.array([[90.0, 0, 20.0], [0, 90.0, 15.0], [0, 0, 1]])
    for i in (0, 24, 48):
        np.testing.assert_array_equal(dtu_fixture.make_camera(i),
                                      jfix.make_camera(i))
        for k in (0, 2):
            for a, b in zip(
                    dtu_fixture.render_view(K, dtu_fixture.make_camera(i), 30,
                                            40, dtu_fixture.scan_params(k)),
                    jfix.render_view(K, jfix.make_camera(i), 30, 40,
                                     jfix.scan_params(k))):
                np.testing.assert_array_equal(a, b)

    K_s1, K_hr = dtu_fixture.fixture_intrinsics()
    np.testing.assert_array_equal(
        K_hr, [[1440.0, 0, 800.0], [0, 1440.0, 600.0], [0, 0, 1]])
    root = dtu_fixture.main([str(tmp_path / "fx"), "--cams", "24",
                             "--lights", "2"])
    assert (root / "list.txt").read_text() == "scan1\n"
    cams = sorted((root / "Cameras/train").iterdir())
    assert len(cams) == 49
    ds = pdatasets.MVSDTUDataset(root, root / "list.txt", "val")
    Kc, E, dmin, interval = ds.read_cam_file(cams[24])
    np.testing.assert_array_equal(E, jfix.make_camera(24).astype(np.float32))
    np.testing.assert_array_equal(Kc, K_s1)
    assert dmin == 425.0 and interval == pytest.approx(2.5 * 1.06)
    rect = root / "Rectified" / "scan1_train"
    assert sorted(p.name for p in rect.iterdir()) == [
        "rect_025_0_r5000.png", "rect_025_1_r5000.png"]
    assert (rect / "rect_025_1_r5000.png").is_symlink()
    depths = root / "Depths" / "scan1"
    assert sorted(p.name for p in depths.iterdir()) == [
        "depth_map_0024.pfm", "depth_visual_0024.png"]
    d = np.asarray(read_pfm(depths / "depth_map_0024.pfm")[0])
    assert d.shape == (1200, 1600) and 500 < d.min() < d.max() < 700


# ---------------------------------------------------------------- CLIs

@pytest.fixture
def small_crop(monkeypatch):
    """``prepare_img`` cut to the 64×96 centre of its 512×640 crop, so the
    CLI's model runs at 64×96 on the CPU."""
    full = pdatasets.prepare_img
    monkeypatch.setattr(pdatasets, "prepare_img",
                        lambda hr: full(hr)[224:288, 272:368])


def seeded_checkpoint(path):
    """A seeded TransMVSNet (ndepths 8, 8, 8) saved in the reference
    trainer's schema, DDP prefixes included → the model."""
    from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig
    from tests.torch_mvs_tol import seeded_state
    torch.manual_seed(7)
    model = TransMVSNet(TransMVSNetConfig(ndepths=(8, 8, 8)))
    model.load_state_dict(seeded_state(model, seed=4))
    torch.save({"model": {"module." + k: v for k, v in
                          model.state_dict().items()}, "epoch": 3}, path)
    return model.eval()


def test_write_prediction_cli(dtu_tree, small_crop, tmp_path):
    """``--mode write_prediction --ckpt`` writes the depth, confidence
    and viridis PNGs of the 4 targets under ``Depths/<scan>/``, named as
    ``data/dtu.py`` reads them; each depth PNG is the checkpoint's model
    run on the sample, ÷ 872/0.7, within ``PNG_LSB``."""
    root, listfile = dtu_tree
    model = seeded_checkpoint(tmp_path / "model.ckpt")
    out = tmp_path / "pred"
    written = mvs_cli.main(["--mode", "write_prediction", "--trainpath",
                            str(root), "--trainlist", str(listfile),
                            "--ckpt", str(tmp_path / "model.ckpt"),
                            "--outpath", str(out), "--device", "cpu",
                            *SMALL_CFG])
    assert sorted(Path(p).name for p in written) == [
        f"depth_map_{v:04d}_TransMVSNet.png" for v in (6, 10, 30, 35)]
    names = sorted(p.name for p in (out / "Depths" / "scan1").iterdir())
    assert names == sorted(f"depth_map_{v:04d}_TransMVSNet{x}.png"
                           for v in (6, 10, 30, 35)
                           for x in ("", "_conf", "_vis"))
    ds = pdatasets.MVSDTUDataset(root, listfile, "val", ndepths=48)
    s = ds[0]
    d = predict.run_model(model, s, "cpu")["depth"][0].numpy()
    png = read_depth_png(out / (s["dpath"][:-4] + "_TransMVSNet.png"))
    assert png.shape == (64, 96)
    err = np.abs(png / 1e-4 - d / predict.DTU_DEPTH_UNSCALE / 1e-4)
    assert err.max() <= PNG_LSB


def test_val_cli_and_modes_not_yet_ported(dtu_tree, small_crop, capsys):
    root, listfile = dtu_tree
    base = ["--trainpath", str(root), "--trainlist", str(listfile),
            "--device", "cpu"]
    scores = mvs_cli.main(["--mode", "val", "--max-steps", "1", *base,
                           *SMALL_CFG])
    assert sorted(scores) == ["abs_depth_error", "thres2mm_error",
                              "thres4mm_error", "thres8mm_error"]
    assert all(np.isfinite(v) for v in scores.values())
    # every mode and dataset is ported now (the training modes, bld and
    # facescape in tests/test_torch_mvs_datasets_train.py, multiface in
    # tests/test_torch_multiface.py); multiface needs its split json
    with pytest.raises(SystemExit) as e:
        mvs_cli.main(["--mode", "val", "--dataset", "multiface", *base])
    assert e.value.code == 2
    assert "--split_config is required" in capsys.readouterr().err


def test_evaluate_cli_writes_the_jax_protocol(tmp_path):
    """``python -m diner_tpu_torch.mvs.evaluate --device cpu`` at 64×64:
    per reference view the depth PFM and PNG, the confidence PFM (stage 3
    × the bilinearly upsampled stages 1 and 2, as ``scripts/mvs_test.py``
    multiplies them), the cam file ``scripts/mvs_test.py`` writes byte for
    byte, the image; then the fused PLY."""
    from diner_tpu.data.io import resize_bilinear as j_resize_bilinear
    jscript = import_script("mvs_test")
    root = general_eval_tree(tmp_path / "scenes")
    out = tmp_path / "out"
    res = pevaluate.main(["--testpath", str(root), "--testlist", "scan1",
                          "--outdir", str(out), "--num_view", "3",
                          "--max_h", "64", "--max_w", "96",
                          "--filter_method", "normal", "--device", "cpu",
                          *SMALL_CFG])
    scan = out / "scan1"
    for sub, files in (("depth_est", ["{}.pfm", "{}.png"]),
                       ("confidence", ["{}.pfm"]),
                       ("cams", ["{}_cam.txt"]), ("images", ["{}.jpg"])):
        assert sorted(p.name for p in (scan / sub).iterdir()) == sorted(
            f.format(f"{v:08d}") for v in range(3) for f in files), sub
    ds = jeval.MVSGeneralEvalDataset(root, ["scan1"], "test", nviews=3,
                                     ndepths=48, max_h=64, max_w=96)
    model = predict.create_model(
        mvs_cli.model_config(mvs_cli.build_parser().parse_args(
            ["--trainpath", "-", *SMALL_CFG])), None, "cpu")
    for i in range(3):
        s = ds[i]
        o = predict.run_model(model, s, "cpu")
        depth = read_pfm(scan / "depth_est" / f"{i:08d}.pfm")[0]
        np.testing.assert_array_equal(depth, o["depth"][0].numpy())
        conf = o["photometric_confidence"][0].numpy()
        for stage in ("stage1", "stage2"):
            c = o[stage]["photometric_confidence"][0].numpy()
            conf = conf * j_resize_bilinear(c, 64, 64)
        np.testing.assert_array_equal(
            read_pfm(scan / "confidence" / f"{i:08d}.pfm")[0], conf)
        dv = s["depth_values"]
        jscript._write_cam(tmp_path / "cam.txt", s["proj_matrices"]
                           ["stage3"][0], float(dv[0]), float(dv[1] - dv[0]))
        assert ((scan / "cams" / f"{i:08d}_cam.txt").read_bytes()
                == (tmp_path / "cam.txt").read_bytes())
    names, floats, colors = read_ply(out / "mvsnet_scan1.ply")
    assert names == ["x", "y", "z"] and colors is not None
    assert res == {"scan1": {"ply": str(out / "mvsnet_scan1.ply"),
                             "points": len(floats)}}
