"""Process-group setup for multi-process training.

Port of ``diner_tpu/parallel/distributed.py:30-80``. The JAX package joins
one global runtime from the ``JAX_*`` coordinator variables; the port joins
a ``torch.distributed`` process group from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), the
reference's own route (``deps/TransMVSNet/train.py:376-381``). One process
drives one GPU, ``cuda:LOCAL_RANK``, over ``nccl``; a CPU run
(``device="cpu"``) uses ``gloo``. Without launcher variables the process is
a world of one on an in-process store, so a single-process run goes through
the same collective path as a multi-process one.

``make_global_array`` has no counterpart: every rank holds the whole host
batch and ``sharding.shard_batch`` keeps its own slice.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from diner_tpu_torch.device import resolve_device

__all__ = ["initialize", "is_multiprocess", "shutdown"]


def _env_int(name: str, given: Optional[int]) -> Optional[int]:
    if given is not None:
        return given
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(device=None, backend: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None,
               master_addr: Optional[str] = None,
               master_port: Optional[int] = None) -> torch.device:
    """Join the process group (idempotent) and return this rank's device.

    Arguments default to torchrun's variables; explicit ones override them.
    ``device`` is ``cuda`` unless the caller asks for the CPU; a CUDA rank
    runs on ``cuda:LOCAL_RANK``. The backend is ``nccl`` on the GPU and
    ``gloo`` on the CPU unless given. A backend that fails to start raises:
    the run never carries on as one process by itself.
    """
    dev = resolve_device(device)
    local_rank = _env_int("LOCAL_RANK", local_rank) or 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if world_size is None or world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return dev
    if rank is None:
        raise ValueError(f"a world of {world_size} needs this process's rank "
                         "(RANK or rank=)")
    master_addr = master_addr or os.environ.get("MASTER_ADDR")
    master_port = _env_int("MASTER_PORT", master_port)
    if master_addr is None or master_port is None:
        raise ValueError(f"a world of {world_size} needs MASTER_ADDR and "
                         "MASTER_PORT (or master_addr= and master_port=)")
    dist.init_process_group(backend,
                            init_method=f"tcp://{master_addr}:{master_port}",
                            rank=rank, world_size=world_size)
    return dev


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def shutdown():
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
