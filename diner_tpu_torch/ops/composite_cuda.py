"""Kernel A — fused alpha compositing, forward, as a CUDA kernel.

Replaces ``diner_tpu/ops/pallas/composite_pallas.py:_fwd_kernel``; the
source and its bound are in ``csrc/composite_fwd.cu``. Same signature as
``diner_tpu.ops.composite.composite``. A CPU tensor goes to the plain
version (``ops/composite.py``); a CUDA tensor goes to the kernel or raises.

The backward kernel is not ported yet, so on CUDA this raises when an input
requires grad: the eval path runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import composite as plain
from diner_tpu_torch.ops import cuda_build
from diner_tpu_torch.ops.composite import CompositeOutput

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L,
             _P, _P, _P, _I, _I, _I, _P]


@functools.cache
def _library():
    lib = cuda_build.load("composite_fwd")
    lib.composite_fwd.argtypes = _ARGTYPES
    lib.composite_fwd.restype = ctypes.c_int
    return lib


def _rows(name, t, shape):
    """``t`` as ``shape`` without a copy; raise if its strides forbid it."""
    try:
        return t.view(shape)
    except RuntimeError as e:
        raise ValueError(f"composite kernel: {name} of shape {tuple(t.shape)}"
                         f" and strides {t.stride()} cannot be read as "
                         f"{shape} without a copy") from e


def composite(rgb, sigma, z_samp, rays, white_bkgd: bool = False
              ) -> CompositeOutput:
    """rgb (SB,B,K,3), sigma/z (SB,B,K), rays (SB,B,8) → CompositeOutput."""
    if rgb.device.type == "cpu":
        return plain.composite(rgb, sigma, z_samp, rays, white_bkgd)
    return composite_kernel(rgb, sigma, z_samp, rays, white_bkgd)


def composite_kernel(rgb, sigma, z_samp, rays, white_bkgd: bool = False
                     ) -> CompositeOutput:
    """Launch kernel A. Inputs may be strided views (e.g. slices of the
    field's (SB, B, K, 4) output) as long as the ray axes merge."""
    global launches
    if sigma.dim() != 3:
        raise ValueError(f"composite kernel: shapes sigma "
                         f"{tuple(sigma.shape)}, expected (SB, B, K)")
    SB, B, K = sigma.shape
    tensors = {"rgb": rgb, "sigma": sigma, "z_samp": z_samp, "rays": rays}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != rgb.device:
            raise ValueError(f"composite kernel: {name} is on {t.device}, "
                             f"expected the CUDA device of rgb")
        if t.dtype != torch.float32:
            raise ValueError(f"composite kernel: {name} is {t.dtype}, "
                             "expected torch.float32")
    if (rgb.shape != (SB, B, K, 3) or z_samp.shape != (SB, B, K)
            or rays.shape != (SB, B, 8)):
        raise ValueError("composite kernel: shapes rgb "
                         f"{tuple(rgb.shape)}, sigma {tuple(sigma.shape)}, "
                         f"z {tuple(z_samp.shape)}, rays {tuple(rays.shape)}")
    if K < 1 or SB * B >= 2 ** 31:
        raise ValueError(f"composite kernel: K={K}, R={SB * B} out of range")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "composite kernel: the backward kernel is not ported yet; call "
            "under torch.no_grad()")
    R = SB * B
    c = _rows("rgb", rgb, (R, K, 3))
    s = _rows("sigma", sigma, (R, K))
    z = _rows("z_samp", z_samp, (R, K))
    far = _rows("rays[..., 7]", rays[..., 7], (R,))
    rgb_out = torch.empty((R, 3), dtype=torch.float32, device=rgb.device)
    depth_out = torch.empty((R,), dtype=torch.float32, device=rgb.device)
    w_out = torch.empty((R, K), dtype=torch.float32, device=rgb.device)
    if R > 0:
        lib = _library()
        with torch.cuda.device(rgb.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.composite_fwd(
                c.data_ptr(), *c.stride(), s.data_ptr(), *s.stride(),
                z.data_ptr(), *z.stride(), far.data_ptr(), far.stride(0),
                rgb_out.data_ptr(), depth_out.data_ptr(), w_out.data_ptr(),
                R, K, int(bool(white_bkgd)), stream)
        if err != 0:
            raise RuntimeError(f"composite kernel launch failed: CUDA error "
                               f"{err}")
        launches += 1
    return CompositeOutput(rgb=rgb_out.view(SB, B, 3),
                           depth=depth_out.view(SB, B),
                           weights=w_out.view(SB, B, K))
