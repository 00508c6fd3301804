"""Import a train state of the JAX package into the port's checkpoint.

Usage (from the repository root):

    python export_jax_checkpoint.py <orbax step_N dir> state.npz  # JAX side
    python -m diner_tpu_torch.train.import_jax state.npz <config.yaml> \\
        DINER|NOVEL|NOVEL_PE|KeypointNeRF|MVS <out ckpt dir> [--device]

The ``.npz`` holds the orbax state's leaves under ``/``-joined paths
(``export_jax_checkpoint.py``): ``params``, ``batch_stats``, optax's
``opt_state`` and ``step`` (DINER, NOVEL and KeypointNeRF states also hold
``vgg_params``). This builds the port's train state for the model and
config (``train/diner.py:TrainStep``, the NOVEL and KeypointNeRF steps,
``mvs/train.py:MVSTrainState``; for MVS the YAML holds ``MVSTrainConfig``'s
fields, its ``model`` those of ``TransMVSNetConfig``, and may be empty),
and fills it in:

- ``params`` and ``batch_stats`` through the flax → torch bridges of
  ``utils/convert.py``;
- Adam's ``mu`` and ``nu``, params-shaped trees, through the same bridges
  into torch Adam's ``exp_avg`` and ``exp_avg_sq``, and its ``count`` into
  each parameter's ``step``: both update with ε outside the square root
  (optax's ``eps_root`` is 0), so the next step is the same step;
- a scheduled Adam's schedule ``count`` (TransMVSNet's WarmupMultiStepLR)
  into the ``LambdaLR``'s ``last_epoch`` and the learning rate it gives;
- ``step`` into the state's count of steps.

It writes ``<out>/step_%08d/state.pt`` with ``train/checkpoint.py``, which
the trainers resume from (``ckpt_path``, or the run's latest checkpoint).
``vgg_params`` are not carried: the port's trainers take VGG19 from
``utils/pretrained.py:load_vgg19`` or ``losses/vgg.py:init_vgg19``. A leaf
the import does not know raises ``KeyError``, as the bridges do.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import yaml

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.utils import convert

KINDS = ("DINER", "NOVEL", "NOVEL_PE", "KeypointNeRF", "MVS")
STATE_KEYS = {"params", "batch_stats", "opt_state", "step", "vgg_params"}


def read_npz(path) -> dict:
    """The exported leaves as a nested dict (list indices as "0", "1", …)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _leaves(tree) -> int:
    return sum(_leaves(v) if isinstance(v, Mapping) else 1
               for v in tree.values())


def adam_state(opt_state: Mapping):
    """optax's Adam state ``{count, mu, nu}`` and, after a schedule, its
    count (else None), from ``opt_state``: one state or the list a chain
    of transforms saves (its empty states wrote nothing)."""
    parts = ([opt_state[k] for k in sorted(opt_state, key=int)]
             if opt_state and all(k.isdigit() for k in opt_state)
             else [opt_state])
    adam, schedule = None, None
    for part in parts:
        if set(part) == {"count", "mu", "nu"} and adam is None:
            adam = part
        elif set(part) == {"count"} and schedule is None:
            schedule = int(part["count"])
        else:
            raise KeyError(f"unknown opt_state entry with {sorted(part)}")
    if adam is None:
        raise KeyError("opt_state holds no Adam state {count, mu, nu}")
    return adam, schedule


def mvs_train_config(raw: Optional[Mapping]):
    """``MVSTrainConfig`` from a YAML mapping of its fields (``model``:
    ``TransMVSNetConfig``'s); lists become tuples."""
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    from diner_tpu_torch.mvs.train import MVSTrainConfig

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in (d or {}).items()}

    raw = dict(raw or {})
    model = TransMVSNetConfig(**fields(raw.pop("model", None)))
    return MVSTrainConfig(model=model, **fields(raw))


def _vgg(device):
    """The perceptual loss's VGG19 as the trainers build it."""
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.utils.pretrained import load_vgg19
    vgg = load_vgg19(device=device)
    return vgg if vgg is not None else init_vgg19(0, device=device)


def build_state(kind: str, config, device=None):
    """The port's train state for ``kind`` with the config at ``config``
    (weights to be overwritten) and its bridge: ``(state, bridge)``, where
    ``bridge(variables)`` maps ``{"params", "batch_stats"}`` to a
    state_dict."""
    dev = resolve_device(device)
    if kind == "MVS":
        from diner_tpu_torch.mvs.train import create_mvs_state
        cfg = mvs_train_config(yaml.safe_load(Path(config).read_text()))
        return create_mvs_state(cfg, device=dev), (
            lambda v: convert.transmvsnet_flax_to_state_dict(
                v, num_stage=cfg.model.num_stage))
    from diner_tpu_torch.train.config import load_train_config
    run_cfg = load_train_config(config, model_name=kind)
    if kind == "DINER":
        from diner_tpu_torch.models.pixelnerf import PixelNeRF
        from diner_tpu_torch.train.diner import TrainStep
        cfg = run_cfg.diner
        vgg = _vgg(dev) if cfg.w_vgg > 0 else None
        return (TrainStep(PixelNeRF(cfg.nerf).to(dev), cfg, vgg),
                convert.flax_to_state_dict)
    if kind in ("NOVEL", "NOVEL_PE"):
        from diner_tpu_torch.losses import init_vgg19
        from diner_tpu_torch.models.novel.model import NovelPixelNeRF
        from diner_tpu_torch.models.novel.train import (
            NovelTrainStep, build_novel_run_config)
        cfg = build_novel_run_config(run_cfg, use_pe=kind == "NOVEL_PE")
        vgg = init_vgg19(0, device=dev) if cfg.w_vgg > 0 else None
        return (NovelTrainStep(NovelPixelNeRF(cfg.nerf).to(dev), cfg, vgg),
                convert.novel_flax_to_state_dict)
    if kind == "KeypointNeRF":
        from diner_tpu_torch.losses import init_vgg19
        from diner_tpu_torch.models.keypointnerf.model import KeypointNeRF
        from diner_tpu_torch.models.keypointnerf.train import (
            KeypointNeRFTrainStep, build_keypointnerf_run_config)
        cfg = build_keypointnerf_run_config(run_cfg)
        vgg = init_vgg19(0, device=dev) if cfg.lambda_vgg > 0 else None
        return (KeypointNeRFTrainStep(KeypointNeRF(cfg.model).to(dev), cfg,
                                      vgg),
                convert.keypointnerf_flax_to_state_dict)
    raise ValueError(f"unknown model {kind!r}; one of {KINDS}")


def _check_keys(got: Mapping, want: Mapping, what: str):
    unknown = sorted(set(got) - set(want))
    if unknown:
        raise KeyError(f"{what}: unknown leaf {unknown[0]} "
                       f"({len(unknown)} in all)")
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"{what}: no leaf for {missing[0]} "
                       f"({len(missing)} in all)")
    for k, v in got.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{what}: {k} is {tuple(v.shape)}, the model's "
                             f"{tuple(want[k].shape)}")


def load_jax_state(state, bridge, tree: Mapping) -> Dict[str, int]:
    """Fill ``state`` (a port train state) from an exported JAX state
    ``tree`` (:func:`read_npz`); returns the counts it set."""
    unknown = sorted(set(tree) - STATE_KEYS)
    if unknown:
        raise KeyError(f"unknown train-state entry {unknown[0]}")
    model, optimizer = state.model, state.optimizer
    params, stats = tree["params"], tree.get("batch_stats", {})
    sd = bridge({"params": params, "batch_stats": stats})
    _check_keys(sd, model.state_dict(), "params and batch_stats")
    named = dict(model.named_parameters())
    if _leaves(params) != len(named):
        raise KeyError(f"params holds {_leaves(params)} leaves, the model "
                       f"{len(named)} parameters")
    model.load_state_dict(sd)

    adam, schedule = adam_state(tree["opt_state"])
    moments = {}
    for name in ("mu", "nu"):
        m = bridge({"params": adam[name], "batch_stats": stats})
        moments[name] = {k: v for k, v in m.items() if k in named}
        _check_keys(moments[name], named, f"Adam's {name}")
    count = int(adam["count"])
    dev = next(model.parameters()).device
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": moments["mu"][name].to(dev),
            "exp_avg_sq": moments["nu"][name].to(dev)}

    scheduler = getattr(state, "scheduler", None)
    if (scheduler is None) != (schedule is None):
        raise KeyError("the state's learning-rate schedule and the "
                       "opt_state's schedule count do not match")
    if scheduler is not None:
        scheduler.last_epoch = schedule
        for group, base, lam in zip(optimizer.param_groups,
                                    scheduler.base_lrs, scheduler.lr_lambdas):
            group["lr"] = base * lam(schedule)
        scheduler._last_lr = [g["lr"] for g in optimizer.param_groups]
    state.step = int(tree["step"])
    return {"step": state.step, "adam_count": count,
            "schedule_count": schedule}


def import_jax(npz, config, kind: str, out_dir, device=None) -> str:
    """Read ``npz``, build ``kind``'s train state from ``config``, fill it
    and save it under ``out_dir``; returns the checkpoint directory."""
    from diner_tpu_torch.train.checkpoint import save_checkpoint
    device = resolve_device(device)  # before any file is read
    tree = read_npz(npz)
    state, bridge = build_state(kind, config, device)
    counts = load_jax_state(state, bridge, tree)
    if "vgg_params" in tree:
        print("vgg_params not carried: the port's trainers take VGG19 from "
              "load_vgg19 (converted weights) or init_vgg19")
    path = save_checkpoint(out_dir, state,
                           config_json=yaml.safe_load(
                               Path(config).read_text()))
    print(f"imported {kind} at step {counts['step']} (Adam count "
          f"{counts['adam_count']}, schedule count "
          f"{counts['schedule_count']}) into {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                      "diner_tpu_torch.train.import_jax")
    ap.add_argument("npz", help="export_jax_checkpoint.py's output")
    ap.add_argument("config", help="the run's YAML (MVS: MVSTrainConfig's "
                                   "fields)")
    ap.add_argument("model", choices=KINDS)
    ap.add_argument("out", help="the checkpoint directory to write "
                                "step_%%08d/ into")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return import_jax(args.npz, args.config, args.model, args.out,
                      args.device)


if __name__ == "__main__":
    main()
