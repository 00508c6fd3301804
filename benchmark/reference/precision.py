"""The precision the reference computes in.

The reference runs in float32 with TF32 off. Its controls run it lower:
``gemm_inputs(fp8)`` rounds both inputs of every matrix product and
convolution to float8 e4m3 with one scale per tensor (the forward only;
gradients pass straight through), the step below bfloat16. The
convolutions and dense layers of this package call :func:`round_input`.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
_round = None


def fp8(t):
    """``t`` rounded to float8 e4m3 at one scale, in ``t``'s dtype, with
    the identity as its gradient."""
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def round_input(t):
    return t if _round is None else _round(t)


@contextlib.contextmanager
def gemm_inputs(fn):
    """Within the block every product's inputs pass through ``fn``."""
    global _round
    old, _round = _round, fn
    try:
        yield
    finally:
        _round = old


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for matrix products and cuDNN convolutions on or off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
