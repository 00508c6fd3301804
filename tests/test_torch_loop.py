"""The port's training entry point: the YAML config against the JAX
package's, the eval-subset protocol, and the trainer loop on the CPU
(fit, checkpoint, resume, validation, the CLI).

``load_train_config`` must give the JAX package's ``DinerConfig`` and run
fields exactly, for every config under ``configs/``; ``select_eval_indices``
the same indices. The trainer runs at the sizes of ``tests/test_loop.py``
(24×24 sphere images, 8 samples from 32 candidates) on the CPU: its noise
comes from torch generators, not JAX's, so it is checked for what it must
do — step counts, checkpoints that restore bit for bit, finite logged
metrics, a scored prediction folder — not against JAX's numbers.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from diner_tpu.train.config import load_train_config as j_load_train_config
from diner_tpu.train.loop import select_eval_indices as j_select
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train.__main__ import main as train_main
from diner_tpu_torch.train.config import build_dataset, load_train_config
from diner_tpu_torch.train.loop import (MetricLogger, Trainer, arrays_of,
                                        select_eval_indices)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
RUN_FIELDS = ("save_dir", "version", "model_name", "val_check_interval",
              "limit_val_batches", "max_steps", "max_epochs",
              "log_every_n_steps", "ckpt_every_n_steps", "ckpt_path",
              "n_samples_score_eval", "cam_sweep_settings", "raw")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores, and with one torch thread per core
    the trainer test runs tens of times slower among them than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_load_train_config_matches_jax(path):
    ours, ref = load_train_config(path), j_load_train_config(path)
    assert dataclasses.asdict(ours.diner) == dataclasses.asdict(ref.diner)
    for name in RUN_FIELDS:
        assert getattr(ours, name) == getattr(ref, name), name
    assert ours.run_dir == ref.run_dir
    for stage in ("train", "val"):
        assert ours.dataloader_kwargs(stage) == ref.dataloader_kwargs(stage)


def test_multiface_config_builds_in_both_packages(tmp_path):
    """configs/evaluate_diner_on_multiface.yaml with ``root`` and
    ``split_config`` pointed at a fabricated multiface tree builds
    ``MultifaceDataset`` in both packages, with the same metas and the same
    first sample, for both stages."""
    from diner_tpu.train.config import build_dataset as j_build_dataset
    from diner_tpu_torch.data.multiface import MultifaceDataset
    from tests.test_multiface import _write_multiface_fixture
    from tests.test_torch_mvs_data import assert_same_sample
    root, split = _write_multiface_fixture(tmp_path, H=128, W=96)
    cfg = load_train_config(ROOT / "configs/evaluate_diner_on_multiface.yaml")
    for stage in ("train", "val"):
        conf = cfg.raw["data"][stage]["dataset"]
        conf = dict(conf, kwargs=dict(conf["kwargs"], root=str(root),
                                      split_config=str(split), downsample=2))
        ours, ref = build_dataset(conf, stage), j_build_dataset(conf, stage)
        assert isinstance(ours, MultifaceDataset) and len(ours) > 0
        assert ours.metas == ref.metas
        assert_same_sample(ours[0], ref[0])
    assert (cfg.diner.znear, cfg.diner.zfar) == (0.5, 1.5)


def test_train_dtu_config_is_the_production_recipe():
    """configs/train_dtu.yaml sets no compute_dtype: it trains in f32."""
    d = load_train_config(ROOT / "configs/train_dtu.yaml").diner
    assert d.nerf.compute_dtype == "float32"
    assert (d.nerf.encoder.backbone, d.nerf.d_hidden, d.nerf.n_blocks) == (
        "resnet34", 512, 5)
    assert (d.renderer.n_samples, d.renderer.n_depth_candidates) == (40, 1000)
    assert (d.w_vgg, d.w_antibias, d.rays_per_step) == (0.1, 1.0, 4096)


def _cfg(tmp_path, **overrides):
    """configs/train_synthetic.yaml at tests/test_loop.py's sizes."""
    raw = yaml.safe_load((ROOT / "configs/train_synthetic.yaml").read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    raw["data"]["train"]["dataset"]["kwargs"].update(
        {"n": 4, "H": 24, "W": 24})
    raw["data"]["val"]["dataset"]["kwargs"].update({"n": 2, "H": 24, "W": 24})
    raw["renderer"]["kwargs"].update(
        {"n_samples": 8, "n_depth_candidates": 32, "n_gaussian": 2,
         "ray_chunk": 192})
    raw["checkpointing"]["kwargs"]["every_n_train_steps"] = 4
    raw["trainer"]["kwargs"].update({"log_every_n_steps": 1,
                                     "val_check_interval": 6})
    raw.update(overrides)
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p


def test_config_compute_dtype_reaches_model(tmp_path):
    """Regression (tests/test_loop.py): ``nerf.kwargs.compute_dtype`` must
    reach the model config."""
    p = _cfg(tmp_path)
    raw = yaml.safe_load(p.read_text())
    raw["nerf"]["kwargs"]["compute_dtype"] = "bfloat16"
    p.write_text(yaml.safe_dump(raw))
    assert load_train_config(p).diner.nerf.compute_dtype == "bfloat16"


def test_dataset_registry():
    sphere = build_dataset({"module": "synthetic_sphere",
                            "kwargs": {"n": 3, "H": 8, "W": 8}}, "val")
    assert len(sphere) == 3 and sphere.stage == "val"
    from diner_tpu.train.config import DATASET_REGISTRY as J_REGISTRY
    from diner_tpu_torch.train.config import DATASET_REGISTRY
    assert sorted(DATASET_REGISTRY) == sorted(J_REGISTRY)  # multiface too
    with pytest.raises(KeyError, match="unknown dataset"):
        build_dataset({"module": "nope"}, "train")


def test_select_eval_indices_matches_jax():
    class FakeDTU:  # 10 names × 7 lights, as DTU's metas collide
        def __len__(self):
            return 70

        def sample_name_of(self, i):
            return f"scan1-{i % 10}"

    class Plain:
        def __len__(self):
            return 20

    for ds, n in ((FakeDTU(), 8), (FakeDTU(), 50), (FakeDTU(), 0),
                  (Plain(), 5), (Plain(), 20)):
        assert select_eval_indices(ds, n) == j_select(ds, n)
    picked = select_eval_indices(FakeDTU(), 8)
    assert len({FakeDTU().sample_name_of(i) for i in picked}) == 8


def _state_equal(saved, train_step):
    """The checkpoint's state equals ``train_step``'s bit for bit."""
    model = train_step.model.state_dict()
    assert saved["step"] == train_step.step
    assert sorted(saved["model"]) == sorted(model)
    for k, v in saved["model"].items():
        assert torch.equal(v, model[k].cpu()), k
    opt = train_step.optimizer.state_dict()
    assert saved["optimizer"]["param_groups"] == opt["param_groups"]
    assert sorted(saved["optimizer"]["state"]) == sorted(opt["state"])
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt["state"][i][k].cpu()), (i, k)


def test_trainer_fit_checkpoint_resume_validate(tmp_path, monkeypatch):
    # JSONL only: importing TensorBoard here would pull in TensorFlow
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfgp = _cfg(tmp_path)
    run_cfg = load_train_config(cfgp)
    trainer = Trainer(run_cfg, num_workers=0, device="cpu")
    ts = trainer.fit(max_steps=4)
    assert ts.step == 4
    ckpt_dir = run_cfg.run_dir / "checkpoints"
    assert ckpt_lib.latest_checkpoint(ckpt_dir) == str(
        ckpt_dir / "step_00000004")
    saved4 = ckpt_lib.load_state(ckpt_dir / "step_00000004")
    _state_equal(saved4, ts)
    assert json.loads((ckpt_dir / "config.json").read_text()) == run_cfg.raw

    # a new trainer restores the latest checkpoint bit for bit ...
    trainer2 = Trainer(load_train_config(cfgp), num_workers=1, device="cpu")
    example = next(iter(trainer2.train_loader))
    _state_equal(saved4, trainer2._init_state(arrays_of(example)))
    # ... and continues to step 6, validating there
    ts2 = trainer2.fit(max_steps=6)
    assert ts2.step == 6
    _state_equal(ckpt_lib.load_state(ckpt_dir / "step_00000006"), ts2)
    moved = [k for k, v in saved4["model"].items()
             if not torch.equal(v, ts2.model.state_dict()[k])]
    assert moved

    rows = [json.loads(line) for line in (run_cfg.run_dir / "logs" /
                                          "metrics.jsonl").read_text()
            .splitlines()]
    train_rows = [r for r in rows if "rgb_fine" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4, 5, 6]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    scores = [r for r in rows if "valscores_psnr" in r]
    assert len(scores) == 1 and scores[0]["step"] == 6
    eval_dir = run_cfg.run_dir / "eval_000006"
    vis = sorted(p.name for p in (eval_dir / "visualizations").iterdir())
    assert vis == sorted(f"sphere-val-{i:04d}{s}" for i in range(2)
                         for s in ("-pred.png", "-gt.png", "-ref.png",
                                   "-depth.png"))
    avg = json.loads((eval_dir / "average_scores.json").read_text())
    for k in ("psnr", "ssim", "l1", "l2", "lpips_proxy"):
        assert math.isfinite(avg[k]), k
    assert (run_cfg.run_dir / "code_snapshot" / "diner_tpu_torch"
            / "train" / "loop.py").exists()


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    """``python -m diner_tpu_torch.train`` without TensorBoard installed
    (JSONL only); a model it does not know is refused."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfgp = _cfg(tmp_path)
    train_main([str(cfgp), "DINER", "--max-steps", "2", "--num-workers",
                "1", "--device", "cpu"])
    run_dir = load_train_config(cfgp).run_dir
    assert ckpt_lib.load_state(run_dir / "checkpoints" /
                               "step_00000002")["step"] == 2
    assert not list((run_dir / "logs").glob("events.*"))
    with pytest.raises(SystemExit) as e:
        train_main([str(cfgp), "IBRNet", "--device", "cpu"])
    assert e.value.code == 2


def test_metric_logger_writes_jsonl_and_tensorboard(tmp_path):
    log = MetricLogger(tmp_path / "logs")
    log.log({"loss": torch.tensor(0.25), "psnr": np.float32(21.5)}, 3)
    log.close()
    assert json.loads((tmp_path / "logs" / "metrics.jsonl").read_text()) == {
        "step": 3, "loss": 0.25, "psnr": 21.5}
    assert list((tmp_path / "logs").glob("events.out.tfevents.*"))
