"""Device resolution for the port's entry points.

The port is written for one NVIDIA GPU. An entry point called without a
device runs on ``cuda``; where there is no GPU it raises instead of falling
back silently, so a CPU run is always one the caller asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diner_tpu_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
