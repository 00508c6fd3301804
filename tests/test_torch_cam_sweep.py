"""The port's validation camera sweeps and ``compare_evaluations`` against
the JAX package's.

The sphere's sweep extrinsics are the same numpy code and must be equal.
One sweep frame goes through both eval steps with bridged weights and the
noise JAX draws from the same key, within 1e-4 as in
``tests/test_torch_eval.py`` (convolutions and matmuls summed in another
order). ``validate`` must write each sweep's animation, 2·nframes − 1
frames played forward then back, and its source views. ``comparison.json``
reads the same reports in both packages and must agree within 1e-6.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diner_tpu.data.synthetic_dataset import SphereDataset as JSphereDataset
from diner_tpu.evaluation.suite import compare_evaluations as j_compare
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train.diner import DinerConfig as JDinerConfig
from diner_tpu.train.diner import make_eval_step as j_make_eval_step
from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from diner_tpu_torch.evaluation import suite
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.config import load_train_config
from diner_tpu_torch.train.diner import DinerConfig, make_eval_step
from diner_tpu_torch.train.loop import Trainer, arrays_of
from diner_tpu_torch.utils import visual
from test_torch_loop import ROOT
from test_torch_render import H, W, RENDER, jax_chunk_noise, small_pair


@pytest.mark.parametrize("nframes", [1, 7, 30])
def test_sphere_sweep_extrinsics_match_jax(nframes):
    got = SphereDataset("val", n=2).get_cam_sweep_extrinsics(nframes,
                                                             scan_idx=1)
    want = JSphereDataset("val", n=2).get_cam_sweep_extrinsics(nframes,
                                                               scan_idx=1)
    assert got.shape == (nframes, 4, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_sweep_frame_matches_jax():
    batch, jm, variables, tm = small_pair(seed=2)
    sweep = SphereDataset("val").get_cam_sweep_extrinsics(5)
    batch = dict(batch, target_extrinsics=sweep[3][None])
    rcfg = dict(RENDER, ray_chunk=512)
    jcfg = JDinerConfig(nerf=jm.cfg, renderer=JRendererConfig(**rcfg))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    key = jax.random.PRNGKey(11)
    j_rgb, j_depth = jax.jit(lambda b, k: j_make_eval_step(jm, jcfg)(
        state, b, k))({k: jnp.asarray(v) for k, v in batch.items()}, key)
    cfg = DinerConfig(nerf=tm.cfg, renderer=RendererConfig(**rcfg))
    noise = jax_chunk_noise(key, 1, H * W, 512, jcfg.renderer)
    rgb, depth = make_eval_step(tm, cfg)(batch, noise=noise)
    assert (depth > 0).float().mean() > 0.05  # the sweep camera sees it
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), atol=1e-4,
                               rtol=0)


def _cfg(tmp_path, nframes=3, n_cam_sweeps=2):
    raw = yaml.safe_load((ROOT / "configs/train_synthetic.yaml").read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    raw["data"]["train"]["dataset"]["kwargs"].update(n=2, H=24, W=24)
    raw["data"]["val"]["dataset"]["kwargs"].update(n=3, H=24, W=24)
    raw["renderer"]["kwargs"].update(n_samples=8, n_depth_candidates=32,
                                     n_gaussian=2, ray_chunk=192)
    raw["optimizer"]["kwargs"].update(
        n_samples_score_eval=1,
        cam_sweep_settings={"nframes": nframes, "n_cam_sweeps": n_cam_sweeps})
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return load_train_config(p)


def _gif_frames(path):
    from PIL import Image, ImageSequence
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in
                ImageSequence.Iterator(im)]


def test_validate_writes_camera_sweeps(tmp_path, monkeypatch):
    from diner_tpu_torch.train import loop
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    run_cfg = _cfg(tmp_path)
    trainer = Trainer(run_cfg, num_workers=0, device="cpu")
    train_step = trainer._init_state(arrays_of(next(iter(
        trainer.train_loader))))
    eval_step = make_eval_step(train_step.model, run_cfg.diner)
    calls, videos = [], []

    def counted(batch, generator=None):
        calls.append(batch["target_extrinsics"].copy())
        return eval_step(batch, generator=generator)

    def spied_save_video(path, frames, fps):
        videos.append(frames)
        return visual.save_video(path, frames, fps)

    monkeypatch.setattr(loop, "save_video", spied_save_video)
    gen = torch.Generator().manual_seed(0)
    scores = trainer.validate(train_step, counted, gen)
    assert "psnr" in scores
    sweeps = run_cfg.run_dir / "eval_000000" / "cam_sweeps"
    # n_cam_sweeps = 2 over 3 validation scenes: linspace(0, 2, 2) → 0, 2;
    # no mp4 writer here, so GIFs
    assert sorted(p.name for p in sweeps.iterdir()) == [
        "sphere-val-0000-ref_imgs.jpg", "sphere-val-0000.gif",
        "sphere-val-0002-ref_imgs.jpg", "sphere-val-0002.gif"]
    # 2·nframes − 1 frames of [rgb; depth], played forward then back as
    # the JAX loop orders them: 0, 1, 2, 2, 1
    frames = videos[0]
    assert len(videos) == 2 and frames.shape == (2 * 3 - 1, 2 * 24, 24, 3)
    np.testing.assert_array_equal(frames[2], frames[3])
    np.testing.assert_array_equal(frames[1], frames[4])
    from PIL import Image
    with Image.open(sweeps / "sphere-val-0000.gif") as im:
        # PIL folds a frame equal to the one before into its duration
        durations = []
        for f in range(im.n_frames):
            im.seek(f)
            durations.append(im.info["duration"])
    assert sum(durations) == 5 * 200
    # the prediction folder's image, then 3 sweep frames per sweep
    sweep_extr = SphereDataset("val").get_cam_sweep_extrinsics(3)
    assert len(calls) == 1 + 2 * 3
    for f, extr in enumerate(calls[1:4]):
        np.testing.assert_array_equal(extr[0], sweep_extr[f])
    ref = np.asarray(Image.open(sweeps / "sphere-val-0000-ref_imgs.jpg"))
    assert ref.shape == (24, 2 * 24, 3)


class _NoSweepAttribute:
    """A validation set without ``get_cam_sweep_extrinsics``."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return self.inner[i]


class _SweepNotImplemented(SphereDataset):
    def get_cam_sweep_extrinsics(self, nframes, scan_idx=None, **_):
        raise NotImplementedError


@pytest.mark.parametrize("wrap", [_NoSweepAttribute, _SweepNotImplemented])
def test_validate_skips_datasets_without_a_sweep(tmp_path, monkeypatch,
                                                 wrap):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    run_cfg = _cfg(tmp_path, nframes=2, n_cam_sweeps=1)
    trainer = Trainer(run_cfg, num_workers=0, device="cpu")
    trainer.val_set = (wrap(trainer.val_set) if wrap is _NoSweepAttribute
                       else wrap("val", n=3, H=24, W=24))
    train_step = trainer._init_state(arrays_of(next(iter(
        trainer.train_loader))))
    eval_step = make_eval_step(train_step.model, run_cfg.diner)
    scores = trainer.validate(train_step, eval_step,
                              torch.Generator().manual_seed(0))
    assert "psnr" in scores
    sweeps = run_cfg.run_dir / "eval_000000" / "cam_sweeps"
    assert not list(sweeps.glob("*")) if sweeps.exists() else True


def test_save_video_falls_back_to_gif(tmp_path, monkeypatch):
    frames = np.random.RandomState(3).rand(4, 6, 5, 3)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    path = visual.save_video(tmp_path / "a.mp4", frames, fps=4)
    assert path == str(tmp_path / "a.gif")
    got = _gif_frames(path)
    assert len(got) == 4
    np.testing.assert_array_equal(
        got[2], (np.clip(frames[2], 0, 1) * 255).astype(np.uint8))
    from PIL import Image
    with Image.open(path) as im:
        assert im.info["duration"] == 250 and im.info["loop"] == 0


def _scored_folder(root, name, noise, seed=7, n=4):
    from PIL import Image
    rng = np.random.RandomState(seed)
    vis = root / name / "visualizations"
    vis.mkdir(parents=True)
    for i in range(n):
        gt = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
        pred = np.clip(gt + rng.randn(20, 24, 3) * noise * (i + 1), 0,
                       255).astype(np.uint8)
        for suffix, img in ((suite.GT_SUFFIX, gt), (suite.PRED_SUFFIX, pred),
                            (suite.REF_SUFFIX, np.concatenate([gt, gt], 1)),
                            (suite.DEPTH_SUFFIX, gt)):
            Image.fromarray(img).save(vis / f"s{i}{suffix}")
    suite.evaluate_folder(vis, root / name, device="cpu")
    return root / name


def test_compare_evaluations_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    dirs = [_scored_folder(tmp_path, "model_a", 6.0),
            _scored_folder(tmp_path, "model_b", 12.0)]
    got = suite.compare_evaluations(dirs, tmp_path / "ours")
    want = j_compare([("model_a", dirs[0]), ("model_b", dirs[1])],
                     tmp_path / "jax")
    files = [json.loads((tmp_path / d / "comparison.json").read_text())
             for d in ("ours", "jax")]
    assert got == files[0]
    assert files[0]["best"] == files[1]["best"] == want["best"]
    # the proxy is no LPIPS entry of METRIC_OPT_DICT, in either package
    assert set(files[0]["best"]) == {"l1", "l2", "psnr", "ssim"}
    assert files[0]["best"]["psnr"] == "model_a"
    for model, scores in files[1]["models"].items():
        for k, v in scores.items():
            mine = files[0]["models"][model][k]
            if isinstance(v, str):
                assert mine == v
            else:
                assert abs(mine - v) <= 1e-6, (model, k)
    # matplotlib imports here: the violins and the difference maps too
    assert (tmp_path / "ours" / suite.BARPLOT_FILENAME).exists()
    assert (tmp_path / "ours" / "biggest_difference_psnr_1.png").exists()


def test_compare_evaluations_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    dirs = [_scored_folder(tmp_path, "a", 6.0, n=2),
            _scored_folder(tmp_path, "b", 9.0, n=2)]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = suite.compare_evaluations([("A", dirs[0]), ("B", dirs[1])],
                                    tmp_path / "cmp")
    assert sorted(p.name for p in (tmp_path / "cmp").iterdir()) == [
        "comparison.json"]
    assert sorted(out["models"]) == ["A", "B"]
