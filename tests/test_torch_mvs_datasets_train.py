"""The MVS training datasets and the training modes of ``python -m
diner_tpu_torch.mvs`` on the CPU.

The datasets (``MVSDTUDataset("train")``, ``MVSBlendedDataset``,
``MVSFacescapeDataset``) are held against the JAX package's on fabricated
trees (as ``tests/test_mvs_eval_datasets.py`` and ``tests/test_mvs_train.py``
build theirs): every entry of a sample equal, dtypes included. The CLI runs
with ``--device cpu`` on a DTU tree of 64×96 images (``prepare_img`` made
the identity, the model at ndepths 8/8/8, base_channels 4): ``--mode train
--max-steps 2`` writes a checkpoint, a second call resumes and its step 3
equals an uninterrupted run's step 3 (the same batch, the same loss within
``LOSS_RTOL``), ``--mode profile`` writes a trace, ``write_prediction``
reads the port checkpoint, ``--dtype bfloat16`` trains, and ``--dataset
multiface`` without its ``--split_config`` exits with status 2 (it trains
in ``tests/test_torch_multiface.py``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diner_tpu.data.io import write_pfm
from diner_tpu.mvs import datasets as jdatasets
from diner_tpu.mvs.eval_datasets import MVSBlendedDataset as JBlended
from diner_tpu.mvs.facescape_dataset import MVSFacescapeDataset as JFacescape
from diner_tpu_torch.mvs import __main__ as mvs_cli
from diner_tpu_torch.mvs import datasets as pdatasets
from diner_tpu_torch.mvs.eval_datasets import MVSBlendedDataset
from diner_tpu_torch.mvs.facescape_dataset import MVSFacescapeDataset
from diner_tpu_torch.train import checkpoint as ckpt_lib
from tests.test_torch_mvs_data import assert_same_sample
from tests.torch_mvs_tol import LOSS_RTOL


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores, and more torch threads than cores
    make every op wait on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cam_lines(K, E, depth_line):
    lines = ["extrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in E]
    lines += ["", "intrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in K]
    lines += ["", depth_line]
    return "\n".join(lines) + "\n"


def dtu_train_tree(root, H, W, cams):
    """A DTU training tree: 49 cam files, ``cams`` rendered (random) at
    H×W with lights 1-6 as links to light 0, depths and visibility
    masks → the list file."""
    rng = np.random.RandomState(0)
    (root / "Cameras/train").mkdir(parents=True)
    for i in range(49):
        K = np.array([[45.0, 0, W / 2], [0, 45.0, H / 2], [0, 0, 1]])
        E = np.eye(4)
        E[:3, 3] = [0.02 * (i % 7 - 3), 0.015 * (i // 7 - 3), 0]
        (root / "Cameras/train" / f"{i:08d}_cam.txt").write_text(
            _cam_lines(K, E, "2.0 0.02"))
    rect = root / "Rectified" / "scan1_train"
    rect.mkdir(parents=True)
    (root / "Depths" / "scan1").mkdir(parents=True)
    for vid in cams:
        img0 = rect / f"rect_{vid + 1:03d}_0_r5000.png"
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            img0, compress_level=1)
        for light in range(1, 7):
            (rect / f"rect_{vid + 1:03d}_{light}_r5000.png").symlink_to(
                img0.name)
        write_pfm(root / "Depths" / "scan1" / f"depth_map_{vid:04d}.pfm",
                  (rng.rand(H, W) * 2 + 2.5).astype(np.float32))
        vis = ((rng.rand(H, W) > 0.2) * 255).astype(np.uint8)
        Image.fromarray(vis).save(root / "Depths" / "scan1" /
                                  f"depth_visual_{vid:04d}.png")
    listfile = root / "list.txt"
    listfile.write_text("scan1\n")
    return listfile


def test_dtu_train_dataset_matches_jax(tmp_path):
    """``MVSDTUDataset("train")``: the quad grid's 36 targets × 7 lights,
    and samples 0 (light 0) and 3 (light 3) equal the JAX package's at
    the full 1200×1600 → 512×640 protocol."""
    listfile = dtu_train_tree(tmp_path, 1200, 1600, (10, 30, 6, 35))
    ours = pdatasets.MVSDTUDataset(tmp_path, listfile, "train")
    ref = jdatasets.MVSDTUDataset(tmp_path, listfile, "train")
    assert len(ours) == len(ref) == 36 * 7
    assert ours.metas == ref.metas
    for i in (0, 3):
        assert_same_sample(ours[i], ref[i])


def _write_pair(path, pairs):
    lines = [str(len(pairs))]
    for ref, srcs in pairs:
        lines.append(str(ref))
        lines.append(" ".join([str(len(srcs))]
                              + [f"{s} {10.0 - k}" for k, s in
                                 enumerate(srcs)]))
    path.write_text("\n".join(lines) + "\n")


def test_blended_dataset_matches_jax(tmp_path):
    """``MVSBlendedDataset`` on a two-scene BlendedMVS tree (a pair with
    too few sources dropped): every sample equal to the JAX package's."""
    rng = np.random.RandomState(0)
    K = np.array([[400.0, 0, 200], [0, 400, 150], [0, 0, 1]])
    for scene in ("scene0", "scene1"):
        scan = tmp_path / "bld" / scene
        for sub in ("cams", "blended_images", "rendered_depth_maps"):
            (scan / sub).mkdir(parents=True)
        _write_pair(scan / "cams" / "pair.txt", [(0, [1, 2]), (1, [0]),
                                                 (2, [0, 1])])
        for vid in range(3):
            E = np.eye(4)
            E[0, 3] = 0.1 * vid
            (scan / "cams" / f"{vid:08d}_cam.txt").write_text(
                _cam_lines(K, E, "2.0 0.01 128 6.0"))
            Image.fromarray((rng.rand(64, 96, 3) * 255).astype(
                np.uint8)).save(scan / "blended_images" / f"{vid:08d}.jpg")
            write_pfm(scan / "rendered_depth_maps" / f"{vid:08d}.pfm",
                      (rng.rand(64, 96) * 5 + 1.5).astype(np.float32))
    listfile = tmp_path / "list.txt"
    listfile.write_text("scene0\nscene1\n")
    for mode in ("train", "val"):
        ours = MVSBlendedDataset(tmp_path / "bld", listfile, mode,
                                 nviews=3, ndepths=64)
        ref = JBlended(tmp_path / "bld", listfile, mode, nviews=3,
                       ndepths=64)
        assert len(ours) == len(ref) == 4
        for i in range(len(ref)):
            assert_same_sample(ours[i], ref[i])


def test_facescape_dataset_matches_jax(tmp_path):
    """``MVSFacescapeDataset`` in train and write_prediction mode on a
    two-view scan (``depth.png`` on one view, the left half of
    ``depth_TransMVSNet.png`` on the other): the metas and every sample
    equal to the JAX package's, the random view choice from the same
    seed."""
    root = tmp_path / "facescape"
    scan = root / "s01" / "f01"
    rng = np.random.RandomState(0)
    cams = {}
    for vid in ("1", "2", "3"):
        vdir = scan / f"view_{int(vid):05d}"
        vdir.mkdir(parents=True)
        rgba = (rng.rand(32, 48, 4) * 255).astype(np.uint8)
        rgba[..., 3] = np.where(rng.rand(32, 48) > 0.3, 255, 0)
        Image.fromarray(rgba).save(vdir / "rgba_colorcalib_v2.png")
        depth = (rng.rand(32, 48) * 2e4).astype(np.uint16)
        if vid == "2":
            Image.fromarray(np.concatenate([depth, depth * 0], 1)).save(
                vdir / "depth_TransMVSNet.png")
        else:
            Image.fromarray(depth).save(vdir / "depth.png")
        cams[vid] = {"extrinsics": np.hstack(
            [np.eye(3), [[0.0], [0.0], [float(vid)]]]).tolist(),
            "intrinsics": [[50.0, 0, 24], [0, 50.0, 16], [0, 0, 1]]}
    (scan / "cameras.json").write_text(json.dumps(cams))
    split = tmp_path / "splits"
    split.mkdir()
    metas = [{"scan_path": "s01/f01", "targets": ["1"],
              "l_refs": ["1", "3"], "r_refs": ["2", "2"],
              "l_refs_val": ["1"], "r_refs_val": ["2"]}]
    for stage in ("train", "val"):
        (split / f"{stage}_metas_binocular.txt").write_text(
            json.dumps(metas))
    for mode in ("train", "write_prediction"):
        ours = MVSFacescapeDataset(root, mode, ndepths=48, split_dir=split)
        ref = JFacescape(root, mode, ndepths=48, split_dir=split)
        assert ours.metas == ref.metas and len(ours) > 1
        for i in range(len(ref)):
            assert_same_sample(ours[i], ref[i])


# ---------------------------------------------------------------- the CLI

TOY_CLI = ["--ndepths", "8,8,8", "--numdepth", "48", "--device", "cpu",
           "--lr", "1e-3"]


@pytest.fixture(scope="module")
def train_tree(tmp_path_factory):
    """A DTU training tree at 64×96 of every camera the quad grid reads."""
    from diner_tpu_torch.mvs.datasets import quad_grid_ids
    targets, srcs = quad_grid_ids(train=True)
    cams = sorted(set(targets) | {c for s in srcs for c in s})
    root = tmp_path_factory.mktemp("mvs_train")
    return root, dtu_train_tree(root, 64, 96, cams)


@pytest.fixture
def small_model(monkeypatch):
    """The CLI at the toy size: images as written (64×96), base_channels
    4 and cr_base_chs 4 (the CLI's own flags set ndepths)."""
    import dataclasses
    monkeypatch.setattr(pdatasets, "prepare_img", lambda hr: hr)
    full = mvs_cli.train_config

    def small(args):
        cfg = full(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, base_channels=4, cr_base_chs=(4, 4, 4)))
    monkeypatch.setattr(mvs_cli, "train_config", small)


def _run(tree, logdir, *extra):
    root, listfile = tree
    return mvs_cli.main(["--trainpath", str(root), "--trainlist",
                         str(listfile), "--logdir", str(logdir), *TOY_CLI,
                         *extra])


def test_train_resume_profile_and_predict_cli(train_tree, small_model,
                                              tmp_path):
    """``--mode train --max-steps 2`` → checkpoint ``step_00000002``; a
    second call resumes to step 3, whose loss equals an uninterrupted
    3-step run's; ``--mode profile`` writes a Chrome trace;
    ``write_prediction --ckpt`` the port checkpoint writes 4 maps."""
    first = _run(train_tree, tmp_path / "a", "--mode", "train",
                 "--max-steps", "2")
    assert [r["step"] for r in first] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["skipped"] == 0 for r in first)
    ckpt = ckpt_lib.latest_checkpoint(tmp_path / "a" / "checkpoints")
    assert ckpt.endswith("step_00000002")
    saved = ckpt_lib.load_state(ckpt)
    assert saved["step"] == 2 and "scheduler" in saved
    resumed = _run(train_tree, tmp_path / "a", "--mode", "train",
                   "--max-steps", "3")
    whole = _run(train_tree, tmp_path / "b", "--mode", "train",
                 "--max-steps", "3")
    assert [r["step"] for r in resumed] == [3]
    assert [r["step"] for r in whole] == [1, 2, 3]
    np.testing.assert_allclose(first[1]["loss"], whole[1]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(resumed[0]["loss"], whole[2]["loss"],
                               rtol=LOSS_RTOL)

    trace_dir = _run(train_tree, tmp_path / "p", "--mode", "profile")
    trace = json.loads((Path(trace_dir) / "trace.json").read_text())
    assert trace["traceEvents"]

    step3 = Path(ckpt).with_name("step_00000003")
    written = _run(train_tree, tmp_path / "a", "--mode", "write_prediction",
                   "--ckpt", str(step3), "--outpath", str(tmp_path / "pred"))
    assert len(written) == 4
    from diner_tpu_torch.data.io import read_depth_png
    for p in written:
        assert np.isfinite(read_depth_png(p)).all()


def test_train_cli_bf16_remat_and_multiface(train_tree, small_model,
                                            tmp_path, capsys):
    """``--dtype bfloat16`` and ``--remat --remat-mode selective`` train
    with finite losses; ``--dataset multiface`` without ``--split_config``
    exits with status 2."""
    bf = _run(train_tree, tmp_path / "bf", "--mode", "train",
              "--max-steps", "1", "--dtype", "bfloat16")
    rm = _run(train_tree, tmp_path / "rm", "--mode", "train",
              "--max-steps", "1", "--remat", "--remat-mode", "selective")
    for recs in (bf, rm):
        assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
    with pytest.raises(SystemExit) as e:
        _run(train_tree, tmp_path / "mf", "--mode", "train", "--dataset",
             "multiface")
    assert e.value.code == 2
    assert "--split_config is required for multiface" in \
        capsys.readouterr().err


def test_debug_nans_runs_under_anomaly_detection(train_tree, small_model,
                                                 tmp_path, monkeypatch):
    """``--debug-nans`` trains inside ``set_detect_anomaly(True)``."""
    seen = []
    real = torch.autograd.set_detect_anomaly

    def spy(mode, *a, **k):
        seen.append(mode)
        return real(mode, *a, **k)
    monkeypatch.setattr(torch.autograd, "set_detect_anomaly", spy)
    recs = _run(train_tree, tmp_path / "dn", "--mode", "train",
                "--max-steps", "1", "--debug-nans")
    assert seen == [True] and np.isfinite(recs[0]["loss"])
