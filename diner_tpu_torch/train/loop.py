"""Training orchestration loop.

Port of ``diner_tpu/train/loop.py`` (which replaces the reference's
Lightning stack, ``python_scripts/train.py`` + ``src/models/diner.py``): an
epoch loop over the prefetching ``DataLoader``, the port's train step
(``train/diner.py:make_train_step``: kernels A, B and C on the card),
periodic validation (prediction folder → evaluation suite → logged
scores → camera-sweep videos), checkpoints with resume, JSONL (and
TensorBoard, where present) metric logging, and a config and code snapshot
in the run directory.

Per-step randomness (pixels and the sampler's noise) comes from a
``torch.Generator`` on the model's device seeded from the count of steps
taken, as the JAX loop seeds its key from the step (``loop.py:180``); the
noise itself differs from JAX's, whose generator is another. Not yet
ported: the device mesh (``parallel/``).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from diner_tpu_torch.data.loader import DataLoader
from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.evaluation import suite as eval_suite
from diner_tpu_torch.losses import init_vgg19
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train.config import TrainRunConfig
from diner_tpu_torch.train.diner import (TrainStep, create_model,
                                         make_eval_step, make_train_step)
from diner_tpu_torch.utils.pretrained import load_vgg19
from diner_tpu_torch.utils.visual import colorize, save_image, save_video


def select_eval_indices(dataset, n: int):
    """Deterministic eval subset — the reference's Random(0) protocol
    (``create_prediction_folder.py:37-40``) extended to dedupe sample-NAME
    collisions (``diner_tpu/train/loop.py:37``).

    DTU metas span 7 lights per (scan, cam) while sample_name is
    "{scan}-{cam}", so colliding draws would overwrite prediction files and
    score fewer images than requested. The first n draws are the
    reference's exact subset; collisions are dropped (first-come wins) and
    replaced from a deterministic continuation of the same RNG until n
    unique names are selected or the dataset is exhausted."""
    idcs = list(range(len(dataset)))
    if not 0 < n < len(idcs):
        return idcs
    rng = random.Random(0)
    first = rng.sample(idcs, n)  # the reference's exact subset
    topup = rng.sample(idcs, len(idcs))  # deterministic extension
    name_of = getattr(dataset, "sample_name_of", None)
    seen_names, seen_idx, picked = set(), set(), []
    for i in first + topup:
        name = name_of(i) if name_of else i
        if i in seen_idx or name in seen_names:
            continue
        seen_idx.add(i)
        seen_names.add(name)
        picked.append(i)
        if len(picked) == n:
            break
    return picked


class MetricLogger:
    """Always a JSONL stream (``metrics.jsonl``); TensorBoard events too
    when ``torch.utils.tensorboard`` is importable."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(str(self.log_dir))

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": int(step)}
        for k, v in metrics.items():
            row[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def arrays_of(batch) -> dict:
    """The batch's numpy arrays (names and other lists stay on the host)."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


class Trainer:
    """Trains the DINER model of a ``TrainRunConfig`` on ``device`` (``cuda``
    unless the caller asks for the CPU)."""

    def __init__(self, run_cfg: TrainRunConfig, num_workers: int = 2,
                 device=None):
        self.cfg = run_cfg
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.run_dir = run_cfg.run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = MetricLogger(self.run_dir / "logs")

        self.train_set = run_cfg.build_dataset("train")
        self.val_set = run_cfg.build_dataset("val")
        self.train_loader = DataLoader(
            self.train_set, num_workers=num_workers,
            **{"batch_size": 4, "shuffle": True,
               **run_cfg.dataloader_kwargs("train")})

        # snapshot the config and code for reproducibility (the reference
        # copies the full source tree into the run dir, general.py:21-27)
        with open(self.run_dir / "config_snapshot.json", "w") as f:
            json.dump(run_cfg.raw, f, indent=2, default=str)
        self._snapshot_code()

    def _snapshot_code(self):
        import diner_tpu_torch
        dst = self.run_dir / "code_snapshot"
        if dst.exists():
            return
        src = Path(diner_tpu_torch.__file__).parent
        try:
            shutil.copytree(
                src, dst / "diner_tpu_torch",
                ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o"))
        except OSError:
            pass  # read-only install; the config snapshot is recorded

    # ------------------------------------------------------------- setup

    def _init_state(self, example_batch) -> TrainStep:
        """The model (seed 0, dead-density reroll, the ImageNet ResNet34
        where converted), VGG19 for the perceptual loss (the converted
        ImageNet weights where present, else seed 0, as
        ``diner_tpu/train/loop.py:133-140``) and the train step, restored
        from ``ckpt_path`` or the run's latest checkpoint when there is
        one."""
        dcfg = self.cfg.diner
        vgg = None
        if dcfg.w_vgg > 0:
            vgg = load_vgg19(device=self.device)
            if vgg is None:
                vgg = init_vgg19(0, device=self.device)
        model = create_model(dcfg, example_batch, seed=0, device=self.device)
        train_step = make_train_step(model, dcfg, vgg)
        if self.cfg.ckpt_path:
            ckpt_lib.restore_checkpoint(self.cfg.ckpt_path, train_step)
        elif (latest := ckpt_lib.latest_checkpoint(
                self.run_dir / "checkpoints")):
            ckpt_lib.restore_checkpoint(latest, train_step)
        return train_step

    # --------------------------------------------------------------- fit

    def fit(self, max_steps: Optional[int] = None) -> TrainStep:
        """Train until ``max_steps`` (default: the config's) or
        ``max_epochs``; returns the train step, whose ``step`` is the count
        of steps taken."""
        cfg = self.cfg
        example = next(iter(DataLoader(
            self.train_set,
            batch_size=self.train_loader.batch_size, num_workers=0)))
        train_step = self._init_state(arrays_of(example))
        eval_step = make_eval_step(train_step.model, cfg.diner)

        limit = max_steps if max_steps is not None else cfg.max_steps
        gen = torch.Generator(device=self.device)
        step = train_step.step
        epoch = 0
        t_last = time.time()
        running = {}

        while True:
            if cfg.max_epochs >= 0 and epoch >= cfg.max_epochs:
                break
            for batch in self.train_loader:
                if limit >= 0 and step >= limit:
                    self._save(train_step)
                    return train_step
                gen.manual_seed(step + 1)
                metrics = train_step(arrays_of(batch), generator=gen)
                step = train_step.step
                for k, v in metrics.items():
                    running[k] = float(v)

                if step % cfg.log_every_n_steps == 0:
                    dt = time.time() - t_last
                    running["steps_per_sec"] = (
                        cfg.log_every_n_steps / dt if dt > 0 else 0.0)
                    t_last = time.time()
                    self.logger.log(running, step)
                    running = {}
                if cfg.ckpt_every_n_steps > 0 and \
                        step % cfg.ckpt_every_n_steps == 0:
                    self._save(train_step)
                if cfg.val_check_interval > 0 and \
                        step % cfg.val_check_interval == 0:
                    self.validate(train_step, eval_step, gen)
            epoch += 1
        self._save(train_step)
        return train_step

    def _save(self, train_step: TrainStep):
        ckpt_lib.save_checkpoint(self.run_dir / "checkpoints", train_step,
                                 config_json=self.cfg.raw)

    # -------------------------------------------------------- validation

    def validate(self, train_step: TrainStep, eval_step, generator):
        """Reference on_validation_epoch_end: checkpoint, prediction folder,
        evaluation suite, logged scores and camera sweeps
        (``src/models/diner.py:310-330``); a dataset without a sweep is
        skipped, as the JAX loop skips it."""
        step = train_step.step
        eval_dir = self.run_dir / f"eval_{step:06d}"
        os.makedirs(eval_dir, exist_ok=True)
        self._save(train_step)

        visdir = eval_dir / "visualizations"
        self.create_prediction_folder(eval_step, visdir, generator)
        scores = eval_suite.evaluate_folder(visdir, eval_dir,
                                            device=self.device)
        self.logger.log({f"valscores_{k}": v for k, v in scores.items()},
                        step)

        try:
            self.create_cam_sweep(eval_step, eval_dir / "cam_sweeps",
                                  generator, **self.cfg.cam_sweep_settings)
        except (AttributeError, NotImplementedError):
            pass  # dataset without sweep support
        return scores

    def create_prediction_folder(self, eval_step, outdir, generator,
                                 dataset=None, n_samples=None):
        """Render ``n_samples`` (default the config's
        ``n_samples_score_eval``) images of ``dataset`` (default the
        validation set) chosen by ``select_eval_indices``, and write each
        one's prediction, colourised depth, source views and ground truth
        under the suite's suffixes."""
        os.makedirs(outdir, exist_ok=True)
        dataset = dataset or self.val_set
        n = n_samples if n_samples is not None else \
            self.cfg.n_samples_score_eval
        idcs = select_eval_indices(dataset, n)
        loader = DataLoader(dataset, batch_size=1,
                            num_workers=self.num_workers,
                            sample_indices=idcs)
        for batch in loader:
            rgb, depth = eval_step(arrays_of(batch), generator=generator)
            rgb = rgb.float().cpu().numpy()
            depth = depth.float().cpu().numpy()
            src = np.asarray(batch["src_rgbs"])  # (B, NV, H, W, 3)
            gt = np.asarray(batch["target_rgb"])
            names = batch["sample_name"]
            for i in range(rgb.shape[0]):
                stem = str(Path(outdir) / names[i])
                save_image(stem + eval_suite.PRED_SUFFIX, rgb[i])
                save_image(stem + eval_suite.DEPTH_SUFFIX,
                           colorize(depth[i]))
                save_image(stem + eval_suite.REF_SUFFIX,
                           np.concatenate(list(src[i]), axis=1))
                save_image(stem + eval_suite.GT_SUFFIX, gt[i])

    def create_cam_sweep(self, eval_step, outdir, generator,
                         nframes: int = 30, n_cam_sweeps: int = 4,
                         fps: int = 5):
        """Camera sweeps of ``n_cam_sweeps`` validation samples spread over
        the set (``diner_tpu/train/loop.py:276-305``): each renders the
        dataset's ``nframes`` sweep cameras from the sample's source views
        and writes ``<name>.mp4`` (a GIF where no mp4 writer exists) of
        [rgb; colourised depth] frames played forward then back
        (2·nframes − 1), and ``<name>-ref_imgs.jpg`` of the source
        views."""
        os.makedirs(outdir, exist_ok=True)
        dataset = self.val_set
        sweep_idcs = np.linspace(0, len(dataset) - 1,
                                 n_cam_sweeps).astype(int)
        for idx in sweep_idcs:
            sample = dataset[int(idx)]
            sweep_extr = dataset.get_cam_sweep_extrinsics(nframes=nframes,
                                                          scan_idx=int(idx))
            frames = []
            for f in range(nframes):
                batch = {k: v[None] for k, v in arrays_of(sample).items()}
                batch["target_extrinsics"] = sweep_extr[f][None]
                rgb, depth = eval_step(batch, generator=generator)
                frames.append(np.concatenate(
                    [rgb[0].float().cpu().numpy(),
                     colorize(depth[0].float().cpu().numpy())], axis=0))
            frames = np.stack(frames)
            frames = frames[list(range(nframes))
                            + list(range(nframes - 1, 0, -1))]
            save_video(Path(outdir) / f"{sample['sample_name']}.mp4",
                       frames, fps)
            save_image(Path(outdir) / f"{sample['sample_name']}-ref_imgs.jpg",
                       np.concatenate(list(sample["src_rgbs"]), axis=1))
