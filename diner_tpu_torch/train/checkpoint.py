"""Checkpoint save and restore of the port's train state.

Port of ``diner_tpu/train/checkpoint.py`` with its layout: each checkpoint
is a directory ``ckpt_dir/step_%08d`` (here holding one ``state.pt``),
beside the run's ``config.json``; ``latest_checkpoint`` picks the highest
step. The state is the whole train state of a ``TrainStep``: the model's
parameters and BN running statistics (``state_dict``), the Adam state
(moments and step counts) and the count of steps taken. It is written with
``torch.save`` to a temporary name and renamed into place, so a reader
never sees a half-written file. A train state with a learning-rate
``scheduler`` (TransMVSNet's, ``mvs/train.py``) saves its state too.
Restoring puts every tensor back where
the train step keeps it (the model's device). An orbax checkpoint written
by the JAX package becomes one of these in two steps, so that the port
never imports JAX: ``export_jax_checkpoint.py`` (where JAX is) writes its
leaves to an ``.npz``, and ``python -m diner_tpu_torch.train.import_jax``
builds the train state from it (``train/import_jax.py``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir, train_step, step: Optional[int] = None,
                    config_json: Optional[dict] = None) -> str:
    """Save ``train_step`` (a ``TrainStep``) under ``ckpt_dir/step_<N>``;
    returns that directory."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = train_step.step
    path = ckpt_dir / f"step_{step:08d}"
    os.makedirs(path, exist_ok=True)
    state = {"model": train_step.model.state_dict(),
             "optimizer": train_step.optimizer.state_dict(),
             "step": int(train_step.step)}
    scheduler = getattr(train_step, "scheduler", None)
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    tmp = path / f".{STATE_FILE}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path / STATE_FILE)
    if config_json is not None:
        with open(ckpt_dir / "config.json", "w") as f:
            json.dump(config_json, f, indent=2, default=str)
    return str(path)


def latest_checkpoint(ckpt_dir) -> Optional[str]:
    """The highest ``step_*`` directory that holds a complete state."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and (p / STATE_FILE).exists())
    return str(steps[-1]) if steps else None


def load_state(path) -> dict:
    """The saved state of checkpoint directory ``path``, on the CPU."""
    return torch.load(Path(path) / STATE_FILE, map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path, train_step):
    """Load checkpoint ``path`` into ``train_step`` (its model, optimizer and
    step count); returns ``train_step``. The model's tensors are copied into
    its own (on its device); the optimizer's moments go to their
    parameters' device, and Adam's per-parameter step counts stay on the
    CPU, where Adam keeps them."""
    state = load_state(path)
    train_step.model.load_state_dict(state["model"])
    train_step.optimizer.load_state_dict(state["optimizer"])
    if "scheduler" in state:
        train_step.scheduler.load_state_dict(state["scheduler"])
    train_step.step = int(state["step"])
    return train_step
