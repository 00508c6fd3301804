"""The port's one-command pipeline (``python -m diner_tpu_torch.pipeline``)
against ``scripts/run_pipeline.py``, on the CPU.

The JAX script is imported from ``scripts/`` (it imports nothing of JAX
at module level). On a fabricated MVS tree (two scans, a few 1200×1600
cameras, light variants as symlinks, scan2's renders links into scan1's):

- ``make_diner_tree`` writes the same files, pixels and link targets;
- both ``main``s, with their stages replaced by fakes that record the
  command and write what the stage would (a depth PNG per source view, a
  checkpoint directory, the scores), for the tiny and the full recipe,
  with and without ``--pruned`` / ``--holdout-cams`` / ``--val-scans``,
  give the same stage commands (script → module, plus ``--device``), the
  same YAML (comments aside) that builds the same config and datasets in
  both packages' loaders, the same split files and a
  ``PIPELINE_RESULT.json`` with the same keys. Everything is compared
  exactly: no stage computes a number.

The tiny chain end to end (TransMVSNet at 512×640 on 49 fabricated
cameras, DINER, the prediction folder) takes minutes on the CPU, so it is
``slow``; ``chip_smoke.py``'s ``pipeline`` phase drives the full recipe on
the card.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diner_tpu.train.config import load_train_config as j_load_train_config
from diner_tpu_torch import pipeline
from diner_tpu_torch.data.io import write_depth_png
from diner_tpu_torch.train.config import load_train_config
from tests.test_torch_loop import RUN_FIELDS
from tests.test_torch_mvs_data import assert_same_sample, import_script

ROOT = Path(__file__).resolve().parents[1]
CAMS = (6, 10, 24, 30, 35)
SRC_CAMS = (30, 10, 6, 35)
SCRIPT_MODULES = {
    "scripts/mvs_train.py": "diner_tpu_torch.mvs",
    "scripts/train.py": "diner_tpu_torch.train",
    "scripts/create_prediction_folder.py": "diner_tpu_torch.predict",
    "scripts/evaluate_prediction_folder.py": "diner_tpu_torch.evaluate",
}
SCORES = {"psnr": 12.5, "ssim": 0.25, "lpips": 0.5, "l1": 0.125,
          "l2": 0.0625}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers at once on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    return import_script("run_pipeline")


def write_mvs_tree(root):
    """The MVS layout of ``data/dtu_fixture.py``: 49 cam files, two scans;
    scan1 has a 1200×1600 render of each of ``CAMS`` (light 0) and light 1
    as a link to it; scan2's lights 0 and 1 link to scan1's renders."""
    from diner_tpu_torch.data.dtu_fixture import fixture_intrinsics, \
        make_camera
    rng = np.random.RandomState(0)
    cams_dir = root / "Cameras" / "train"
    cams_dir.mkdir(parents=True)
    K = fixture_intrinsics()[0]
    for i in range(49):
        lines = ["extrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in make_camera(i)]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in K]
        lines += ["", "425.0 2.5"]
        (cams_dir / f"{i:08d}_cam.txt").write_text("\n".join(lines) + "\n")
    s1 = root / "Rectified" / "scan1_train"
    s2 = root / "Rectified" / "scan2_train"
    s1.mkdir(parents=True)
    s2.mkdir(parents=True)
    for c in CAMS:
        # 8×8 blocks of noise: real pixels, quick to encode
        img = np.repeat(np.repeat(rng.randint(0, 256, (150, 200, 3), np.uint8),
                                  8, 0), 8, 1)
        name = f"rect_{c + 1:03d}_0_r5000.png"
        Image.fromarray(img).save(s1 / name, compress_level=1)
        (s1 / f"rect_{c + 1:03d}_1_r5000.png").symlink_to(name)
        for light in (0, 1):
            (s2 / f"rect_{c + 1:03d}_{light}_r5000.png").symlink_to(
                Path("..") / "scan1_train" / name)
    for scan in ("scan1", "scan2"):
        (root / "Depths" / scan).mkdir(parents=True)
    (root / "list.txt").write_text("scan1\nscan2\n")


@pytest.fixture(scope="module")
def mvs_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline") / "dtu"
    write_mvs_tree(root)
    return root


def tree_entries(top):
    """{relative path: ("link", target) | ("file", pixels or bytes)} of
    every file and link under ``top``, links not followed."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(top):
        for name in dirnames + filenames:
            p = Path(dirpath) / name
            rel = str(p.relative_to(top))
            if p.is_symlink():
                out[rel] = ("link", os.readlink(p))
            elif p.is_file():
                out[rel] = ("file", np.asarray(Image.open(p))
                            if p.suffix == ".png" else p.read_bytes())
    return out


def test_make_diner_tree_matches_jax(tmp_path, mvs_tree, jax_script):
    """The same files, pixels and link targets as the JAX script's, the
    light links relative (scan2's across scan directories), ``Depths`` a
    link to the MVS tree's; a second call (re-entry) changes nothing."""
    pipeline.make_diner_tree(mvs_tree, tmp_path / "port")
    jax_script.make_diner_tree(mvs_tree, tmp_path / "jax")
    ours, ref = tree_entries(tmp_path / "port"), tree_entries(tmp_path / "jax")
    assert sorted(ours) == sorted(ref)
    for rel, (kind, val) in ref.items():
        assert ours[rel][0] == kind, rel
        if kind == "link":
            assert ours[rel][1] == val, rel
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(ours[rel][1], val, err_msg=rel)
        else:
            assert ours[rel][1] == val, rel
    rect = tmp_path / "port" / "Rectified"
    assert ours["Depths"] == ("link", str(mvs_tree / "Depths"))
    assert os.readlink(rect / "scan2_train" / "rect_007_0_r5000.png") == \
        "../scan1_train/rect_007_0_r5000.png"
    assert Image.open(rect / "scan2_train" / "rect_007_1_r5000.png").size \
        == (640, 512)
    pipeline.make_diner_tree(mvs_tree, tmp_path / "port")
    assert sorted(tree_entries(tmp_path / "port")) == sorted(ours)


def fake_stage(kind, args, root, work):
    """What a stage leaves behind that the pipeline reads: write_prediction
    a depth and a confidence PNG of each source view in every scan,
    training a checkpoint directory, the scoring its average scores."""
    args = [str(a) for a in args]
    if kind == "mvs" and "write_prediction" in args:
        rng = np.random.RandomState(1)
        for scan in ("scan1", "scan2"):
            for c in SRC_CAMS:
                stem = root / "Depths" / scan / f"depth_map_{c:04d}"
                write_depth_png(f"{stem}_TransMVSNet.png",
                                rng.uniform(0.45, 0.6, (512, 640)))
                write_depth_png(f"{stem}_TransMVSNet_conf.png",
                                rng.uniform(0.0, 1.0, (512, 640)))
    elif kind == "train":
        (work / "diner" / "DINER_pipeline" / "checkpoints" /
         "step_00000020").mkdir(parents=True)
    elif kind == "evaluate":
        Path(args[0]).mkdir(exist_ok=True)
        Path(args[0], "average_scores.json").write_text(json.dumps(SCORES))


def outputs(work):
    """The files a run leaves that the tests compare: each YAML without
    its comments, the split files, the result."""
    def yaml_body(name):
        return [ln for ln in (work / name).read_text().splitlines()
                if not ln.startswith("#")]
    return dict(
        train_yaml=yaml_body("train_diner_pipeline.yaml"),
        eval_yaml=yaml_body("eval_diner_pipeline.yaml"),
        splits={p.name: p.read_text() for p in (work / "splits").iterdir()},
        result=json.loads((work / "PIPELINE_RESULT.json").read_text()))


def run_jax(jax_script, monkeypatch, argv, root, work):
    """The JAX script's ``main`` with ``run`` faked → (commands as (module,
    args) pairs, outputs)."""
    calls = []

    def run(cmd, log, env=None, retries=2):
        module = SCRIPT_MODULES[str(cmd[1])]
        calls.append((module, [str(a) for a in cmd[2:]]))
        fake_stage(module.split(".")[-1], cmd[2:], root, work)
        return 1.0

    monkeypatch.setattr(jax_script, "run", run)
    monkeypatch.setattr(sys, "argv", ["run_pipeline.py", *argv])
    jax_script.main()
    return calls, outputs(work)


def run_port(argv, root, work):
    calls = []

    def run_stage(module, args, log):
        assert Path(log) == work / "pipeline.log"
        calls.append((module, [str(a) for a in args]))
        fake_stage(module.split(".")[-1], args, root, work)

    summary = pipeline.main(argv, run_stage=run_stage)
    return calls, outputs(work), summary


CASES = {
    "tiny": ["--tiny"],
    "full": [],
    # the tiny recipe's 64 candidates are no multiple of the pruned
    # sampler's 125 coarse bins, so it has no pruned case
    "tiny_holdout": ["--tiny", "--holdout-cams", "24,30"],
    "full_pruned_holdout": ["--pruned", "both", "--holdout-cams", "24,30"],
    "full_pruned_train_val_scans": [
        "--pruned", "train", "--val-scans", "scan2", "--train-downsample",
        "1.0", "--val-interval", "7", "--sweep-frames", "2", "--n-sweeps",
        "1", "--val-views", "2", "--eval-n", "2", "--mvs-steps", "3",
        "--diner-steps", "25", "--dtype", "float32"],
    "full_skip_mvs": ["--skip-mvs"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_glue_matches_jax(case, tmp_path, mvs_tree, jax_script,
                                   monkeypatch):
    """Both ``main``s on the same tree and workdir (one after the other):
    the same stage commands, YAMLs, splits and result keys; both packages'
    loaders build the same config and datasets from the generated YAMLs."""
    work = tmp_path / "work"
    argv = ["--root", str(mvs_tree), "--workdir", str(work), *CASES[case]]
    j_calls, j_out = run_jax(jax_script, monkeypatch, argv, mvs_tree, work)
    j_cfgs = tmp_path / "jax_cfgs"
    j_cfgs.mkdir()
    for name in ("train_diner_pipeline.yaml", "eval_diner_pipeline.yaml"):
        (j_cfgs / name).write_bytes((work / name).read_bytes())
    import shutil
    shutil.rmtree(work)

    calls, out, summary = run_port([*argv, "--device", "cpu"], mvs_tree,
                                   work)
    assert [m for m, _ in calls] == [m for m, _ in j_calls]
    for (_, args), (_, j_args) in zip(calls, j_calls):
        assert args == j_args + ["--device", "cpu"]
    assert out["train_yaml"] == j_out["train_yaml"]
    assert out["eval_yaml"] == j_out["eval_yaml"]
    assert out["splits"] == j_out["splits"]
    res, j_res = out["result"], j_out["result"]
    assert sorted(res) == sorted(j_res) and summary == res
    assert sorted(res["stages_s"]) == sorted(j_res["stages_s"])
    for k in ("scores", "n_images", "eval_image_hw", "eval_rays_total"):
        assert res[k] == j_res[k], k
    assert res["config"] == j_res["config"]
    assert (work / "PIPELINE_RESULT.json").exists()

    for name in ("train_diner_pipeline.yaml", "eval_diner_pipeline.yaml"):
        ours = load_train_config(work / name)
        ref = j_load_train_config(j_cfgs / name)
        assert dataclasses.asdict(ours.diner) == \
            dataclasses.asdict(ref.diner)
        for field in RUN_FIELDS:
            assert getattr(ours, field) == getattr(ref, field), field
        assert ours.run_dir == ref.run_dir
        for stage in ("train", "val"):
            assert ours.dataloader_kwargs(stage) == \
                ref.dataloader_kwargs(stage)
            ds, j_ds = ours.build_dataset(stage), ref.build_dataset(stage)
            assert len(ds) == len(j_ds) > 0 and ds.metas == j_ds.metas
            assert ds.scan_list == j_ds.scan_list
        if case == "full_pruned_holdout":
            assert_same_sample(ds[0], j_ds[0])
            assert ds[0]["target_view_id"] == 24


def test_full_recipe_widths():
    """The default recipe is the reference DTU one: TransMVSNet at
    48/32/8 of 192 with remat, DINER ResNet34 + ResnetFC 5 × 512, 40 of
    1000 samples, 15 Gaussians, 128 rays, a 64 px VGG patch, trained at
    downsample 0.5 and scored at 512×640 with 64 samples."""
    args = pipeline.build_parser().parse_args(["--root", "r", "--workdir",
                                               "w"])
    numdepth, diner, eval_ds, eval_ns = pipeline.recipe(args)
    assert (args.ndepths, args.depth_inter_r, numdepth) == (
        "48,32,8", "4,1,0.5", 192)
    assert (diner["backbone"], diner["d_hidden"], diner["n_samples"],
            diner["n_cand"], diner["n_gaussian"], diner["ray_batch_size"],
            diner["vgg_spatch"], diner["downsample"],
            diner["compute_dtype"]) == (
        "resnet34", 512, 40, 1000, 15, 128, 64, 0.5, "bfloat16")
    assert (eval_ds, eval_ns, args.device) == (1.0, 64, "cuda")


def test_val_scans_must_name_scans_of_the_tree(tmp_path, mvs_tree):
    with pytest.raises(SystemExit, match="scan9"):
        pipeline.main(["--root", str(mvs_tree), "--workdir",
                       str(tmp_path), "--val-scans", "scan9", "--device",
                       "cpu"], run_stage=lambda *a: None)
    with pytest.raises(SystemExit, match="no scan to train"):
        pipeline.main(["--root", str(mvs_tree), "--workdir",
                       str(tmp_path), "--val-scans", "scan1,scan2",
                       "--device", "cpu"], run_stage=lambda *a: None)


def test_cuda_by_default(tmp_path, mvs_tree, monkeypatch):
    """Without ``--device`` the pipeline runs on the GPU: where there is
    none it raises before any stage runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="GPU"):
        pipeline.main(["--root", str(mvs_tree), "--workdir", str(tmp_path)],
                      run_stage=lambda *a: calls.append(a))
    assert calls == []


def test_skip_diner_needs_a_checkpoint(tmp_path, mvs_tree):
    calls = []
    with pytest.raises(SystemExit, match="no checkpoint"):
        pipeline.main(["--root", str(mvs_tree), "--workdir", str(tmp_path),
                       "--skip-mvs", "--skip-diner", "--device", "cpu"],
                      run_stage=lambda *a: calls.append(a))
    assert calls == []


def test_failed_stage_ends_the_run_without_retry(tmp_path, capsys):
    """``run_module`` runs ``python -m <module>`` once; a nonzero exit ends
    the run with the log's tail on standard error."""
    log = tmp_path / "pipeline.log"
    with pytest.raises(SystemExit, match="exit 2"):
        pipeline.run_module("diner_tpu_torch.fusion",
                            ["--scan_dir", "s", "--out", "o",
                             "--no-such-flag"], log)
    text = log.read_text()
    assert text.count("$ ") == 1 and "--no-such-flag" in text
    assert "unrecognized arguments" in capsys.readouterr().err
    pipeline.run_module("diner_tpu_torch.fusion", ["--help"], log)
    assert "--scan_dir" in log.read_text()


@pytest.mark.parametrize("module", [
    "diner_tpu_torch.mvs", "diner_tpu_torch.train", "diner_tpu_torch.predict",
    "diner_tpu_torch.evaluate", "diner_tpu_torch.fusion",
    "diner_tpu_torch.pipeline"])
def test_stage_modules_run_as_main(module):
    """Each module the pipeline runs as ``python -m`` (and the two new
    CLIs) parses its arguments when run so: ``python -m
    diner_tpu_torch.mvs`` once exited 0 doing nothing."""
    p = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and f"usage: python -m {module}" in p.stdout, \
        p.stdout + p.stderr


def test_no_jax_import():
    """The pipeline and the fusion CLI import neither JAX nor the JAX
    package, not even through the stages they name."""
    code = ("import sys; import diner_tpu_torch.pipeline, "
            "diner_tpu_torch.fusion.__main__; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'diner_tpu', 'flax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


@pytest.mark.slow
def test_tiny_chain_end_to_end(tmp_path):
    """``python -m diner_tpu_torch.pipeline --tiny --device cpu`` on a
    fixture of all 49 cameras (DINER's training set takes any of them as
    its target): every stage exits 0, write_prediction's PNGs are in the
    tree, the prediction folder holds 2 pred / gt pairs and the scores are
    finite."""
    root = tmp_path / "dtu"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m",
                        "diner_tpu_torch.data.dtu_fixture", str(root)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=1200, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    work = tmp_path / "work"
    p = subprocess.run(
        [sys.executable, "-m", "diner_tpu_torch.pipeline", "--root",
         str(root), "--workdir", str(work), "--tiny", "--mvs-steps", "1",
         "--diner-steps", "20", "--eval-n", "2", "--dtype", "float32",
         "--val-views", "2", "--sweep-frames", "2", "--n-sweeps", "1",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=3300, env=env)
    assert p.returncode == 0, (p.stdout[-3000:], p.stderr[-3000:])
    assert len(sorted(root.rglob("depth_map_*_TransMVSNet.png"))) >= 4
    assert len(sorted(root.rglob("depth_map_*_TransMVSNet_conf.png"))) >= 4
    scores = json.loads((work / "PIPELINE_RESULT.json").read_text())["scores"]
    for k in ("psnr", "ssim", "l1", "l2"):
        assert np.isfinite(scores[k]), scores
    assert len(list((work / "prediction").glob("*-pred.png"))) == 2
    assert len(list((work / "prediction").glob("*-gt.png"))) == 2
