"""Metric aggregation and multi-process scalar reduction.

Port of ``diner_tpu/utils/meters.py``. Parity targets: TransMVSNet's
``DictAverageMeter`` (``deps/TransMVSNet/utils.py:218-239``),
``reduce_scalar_outputs`` (:298-321) and ``synchronize()`` (:277-289). The
collectives are ``torch.distributed``'s, over the process group the caller
initialised; without one (or with one process) they are the identity.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


class DictAverageMeter:
    """Running mean of a dict of scalars (utils.py:218-239)."""

    def __init__(self):
        self.sum_data: Dict[str, float] = {}
        self.count = 0

    def update(self, new: Mapping[str, float], n: int = 1):
        self.count += n
        for k, v in new.items():
            v = float(v)
            self.sum_data[k] = self.sum_data.get(k, 0.0) + v * n

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1)
                for k, v in self.sum_data.items()}

    def reset(self):
        self.sum_data = {}
        self.count = 0


def _distributed() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def reduce_scalar_dict(scalars: Mapping[str, float],
                       average: bool = True) -> Dict[str, float]:
    """Mean (or sum) of per-process scalar dicts across the process group;
    every process gets the result. One process: the identity."""
    if not _distributed() or torch.distributed.get_world_size() == 1:
        return {k: float(v) for k, v in scalars.items()}
    return _allreduce(scalars, average)


def _allreduce(scalars: Mapping[str, float],
               average: bool = True) -> Dict[str, float]:
    """The reduction core: one all-reduce of the values in key order (f32,
    as the JAX package's all-gather; on the CPU for gloo, on the current GPU
    for nccl)."""
    dist = torch.distributed
    keys = sorted(scalars)
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    vec = torch.tensor([float(scalars[k]) for k in keys],
                       dtype=torch.float32, device=device)
    dist.all_reduce(vec)
    if average:
        vec /= dist.get_world_size()
    return {k: float(vec[i]) for i, k in enumerate(keys)}


def synchronize():
    """Barrier across the process group (utils.py:277-289); a no-op for
    one process."""
    if _distributed() and torch.distributed.get_world_size() > 1:
        torch.distributed.barrier()
