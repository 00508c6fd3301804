"""TransMVSNet training: the config, the learning-rate schedule, the train
state and the train step.

Port of ``diner_tpu/mvs/train.py:27-100`` (reference ``deps/TransMVSNet/
train.py``): Adam with optax's defaults (β 0.9 / 0.999, eps 1e-8, no weight
decay) under WarmupMultiStepLR, the stage-weighted entropy loss, and the
NaN guard: on a non-finite loss the gradients are zeroed and the Adam
update is still applied (the moments decay, the count advances, the
parameters move by the momentum), and the batch's BN statistics are kept,
exactly as the JAX step does. The step's BN runs in train mode (batch
statistics, flax's running update); the activations compute in
``compute_dtype`` while parameters stay f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from diner_tpu_torch.mvs.loss import trans_mvsnet_loss
from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MVSTrainConfig:
    model: TransMVSNetConfig = TransMVSNetConfig()
    lr: float = 1e-3
    # WarmupMultiStepLR (deps/TransMVSNet/utils.py:323): linear warmup then
    # step decay at the milestones
    warmup_steps: int = 500
    warmup_factor: float = 1.0 / 3
    milestones: Tuple[int, ...] = (10000, 12000, 14000)
    gamma: float = 0.5
    dlossw: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # activation / matmul dtype ("float32" | "bfloat16"); params stay f32
    compute_dtype: str = "float32"


def warmup_multistep_schedule(cfg: MVSTrainConfig):
    """The learning rate as a function of the number of updates already
    applied (the JAX schedule, which optax evaluates before each update)."""
    def schedule(step):
        warm = min(step / max(cfg.warmup_steps, 1), 1.0)
        factor = cfg.warmup_factor + (1 - cfg.warmup_factor) * warm
        decay = 1.0
        for m in cfg.milestones:
            decay *= cfg.gamma if step >= m else 1.0
        return cfg.lr * factor * decay
    return schedule


@dataclass
class MVSTrainState:
    """The model, its Adam, the schedule (a ``LambdaLR`` stepped after each
    update, so update k uses the schedule at k) and the update count: what
    ``train/checkpoint.py`` saves and restores."""

    model: TransMVSNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def create_mvs_state(cfg: MVSTrainConfig, seed: int = 0, example_batch=None,
                     device=None) -> MVSTrainState:
    """A TransMVSNet drawn from ``seed`` (the global RNG is left as it
    was) on ``device`` (default ``cuda``), its Adam and schedule. With an
    ``example_batch``, its image size is checked: every stage halves it
    three times, so H and W must divide by 32."""
    from diner_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if example_batch is not None:
        H, W = example_batch["imgs"].shape[-3:-1]
        if H % 32 or W % 32:
            raise ValueError(f"TransMVSNet needs H and W divisible by 32, "
                             f"got {H}×{W}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TransMVSNet(cfg.model, dtype=DTYPES[cfg.compute_dtype])
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    schedule = warmup_multistep_schedule(cfg)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / cfg.lr)
    return MVSTrainState(model, optimizer, scheduler)


def batch_to_device(batch, device):
    """A collated numpy batch → tensors on ``device`` (nested dicts kept;
    names and other non-arrays dropped)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = batch_to_device(v, device)
        elif hasattr(v, "dtype") and hasattr(v, "shape"):
            out[k] = torch.as_tensor(v, device=device)
    return out


def make_mvs_train_step(state: MVSTrainState, cfg: MVSTrainConfig):
    """The train step: ``step(batch) → (loss, depth_loss, entropy,
    skipped)`` as 0-d tensors on the model's device (no host sync), the
    batch's tensors already there (:func:`batch_to_device`)."""
    model, optimizer, scheduler = state.model, state.optimizer, \
        state.scheduler
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=False)
        out = model(batch["imgs"], batch["proj_matrices"],
                    batch["depth_values"])
        total, depth_loss, entropy, _ = trans_mvsnet_loss(
            out, batch["depth"], batch["mask"], dlossw=cfg.dlossw)
        total.backward()
        # the NaN guard (diner_tpu/mvs/train.py:80-84): zero gradients, the
        # update still applied; zeros (not None) so Adam steps every moment
        finite = torch.isfinite(total.detach())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.masked_fill_(~finite, 0.0)
        optimizer.step()
        scheduler.step()
        state.step += 1
        return (total.detach(), depth_loss.detach(), entropy.detach(),
                (~finite).float())

    return step
