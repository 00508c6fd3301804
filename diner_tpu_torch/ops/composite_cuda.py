"""Kernels A and B — fused alpha compositing, forward and backward, as CUDA
kernels behind one ``torch.autograd.Function``.

Kernel A (``csrc/composite_fwd.cu``) replaces
``diner_tpu/ops/pallas/composite_pallas.py:_fwd_kernel``; kernel B
(``csrc/composite_bwd.cu``) replaces its ``_bwd_kernel``. Their bounds are
in the sources. ``composite`` has the signature of
``diner_tpu.ops.composite.composite`` and is differentiable with respect
to rgb and sigma, as ``composite_pallas`` is (``composite_pallas.py:130-181``):
z and the rays come from the sampler, which stops their gradient. For a
CPU tensor the Function's forward and backward are the plain versions
(``ops/composite.py``); for a CUDA tensor they are kernels A and B, or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import composite as plain
from diner_tpu_torch.ops import cuda_build
from diner_tpu_torch.ops.composite import CompositeOutput

# kernel launches since the count was last set to 0 (read by chip_smoke.py):
# kernel A in ``launches``, kernel B in ``bwd_launches``
launches = 0
bwd_launches = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FWD_ARGTYPES = [_P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L,
                 _P, _P, _P, _I, _I, _I, _P]
_BWD_ARGTYPES = [_P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L,
                 _P, _L, _L, _P, _L, _P, _L, _L,
                 _P, _P, _I, _I, _I, _P]


@functools.cache
def _library(name):
    fn = getattr(cuda_build.load(name), name)
    fn.argtypes = _FWD_ARGTYPES if name == "composite_fwd" else _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _rows(name, t, shape):
    """``t`` as ``shape`` without a copy; raise if its strides forbid it."""
    try:
        return t.view(shape)
    except RuntimeError as e:
        raise ValueError(f"composite kernel: {name} of shape {tuple(t.shape)}"
                         f" and strides {t.stride()} cannot be read as "
                         f"{shape} without a copy") from e


def _check_inputs(rgb, sigma, z_samp, rays):
    """Validate the forward's inputs for the kernels → (R, K)."""
    if sigma.dim() != 3:
        raise ValueError(f"composite kernel: shapes sigma "
                         f"{tuple(sigma.shape)}, expected (SB, B, K)")
    SB, B, K = sigma.shape
    for name, t in {"rgb": rgb, "sigma": sigma, "z_samp": z_samp,
                    "rays": rays}.items():
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
    return SB * B, K


def _launch(name, device, *args):
    err = cuda_build.launch(_library(name), device, *args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def composite_kernel(rgb, sigma, z_samp, rays, white_bkgd: bool = False
                     ) -> CompositeOutput:
    """Launch kernel A (no autograd). Inputs may be strided views (e.g.
    slices of the field's (SB, B, K, 4) output) as long as the ray axes
    merge."""
    global launches
    R, K = _check_inputs(rgb, sigma, z_samp, rays)
    SB, B = sigma.shape[:2]
    c = _rows("rgb", rgb, (R, K, 3))
    s = _rows("sigma", sigma, (R, K))
    z = _rows("z_samp", z_samp, (R, K))
    far = _rows("rays[..., 7]", rays[..., 7], (R,))
    rgb_out = torch.empty((R, 3), dtype=torch.float32, device=rgb.device)
    depth_out = torch.empty((R,), dtype=torch.float32, device=rgb.device)
    w_out = torch.empty((R, K), dtype=torch.float32, device=rgb.device)
    if R > 0:
        _launch("composite_fwd", rgb.device,
                c.data_ptr(), *c.stride(), s.data_ptr(), *s.stride(),
                z.data_ptr(), *z.stride(), far.data_ptr(), far.stride(0),
                rgb_out.data_ptr(), depth_out.data_ptr(),
                w_out.data_ptr(), R, K, int(bool(white_bkgd)))
        launches += 1
    return CompositeOutput(rgb=rgb_out.view(SB, B, 3),
                           depth=depth_out.view(SB, B),
                           weights=w_out.view(SB, B, K))


def _cotangent(name, g, shape, device):
    """A cotangent as ``shape`` (a view where its strides allow, else a
    copy: autograd may hand expanded tensors), or None."""
    if g is None:
        return None
    if g.device != device or g.dtype != torch.float32:
        raise ValueError(f"composite kernel: {name} is {g.dtype} on "
                         f"{g.device}, expected torch.float32 on {device}")
    return g.reshape(shape)


def composite_bwd_kernel(rgb, sigma, z_samp, rays, g_rgb, g_depth=None,
                         g_w=None, white_bkgd: bool = False):
    """Launch kernel B: the VJP of :func:`composite` for rgb and sigma.

    Shapes as :func:`composite`'s inputs and outputs; g_depth and g_w may
    be None (zero) and are then not read. Returns (d_rgb (SB, B, K, 3),
    d_sigma (SB, B, K)), contiguous.
    """
    global bwd_launches
    R, K = _check_inputs(rgb, sigma, z_samp, rays)
    SB, B = sigma.shape[:2]
    dev = rgb.device
    c = _rows("rgb", rgb, (R, K, 3))
    s = _rows("sigma", sigma, (R, K))
    z = _rows("z_samp", z_samp, (R, K))
    far = _rows("rays[..., 7]", rays[..., 7], (R,))
    if g_rgb is None:
        g_rgb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    gr = _cotangent("g_rgb", g_rgb, (R, 3), dev)
    gd = _cotangent("g_depth", g_depth, (R,), dev)
    gw = _cotangent("g_w", g_w, (R, K), dev)
    d_rgb = torch.empty((R, K, 3), dtype=torch.float32, device=dev)
    d_sigma = torch.empty((R, K), dtype=torch.float32, device=dev)
    if R > 0:
        _launch("composite_bwd", dev,
                c.data_ptr(), *c.stride(), s.data_ptr(), *s.stride(),
                z.data_ptr(), *z.stride(), far.data_ptr(), far.stride(0),
                gr.data_ptr(), *gr.stride(),
                None if gd is None else gd.data_ptr(),
                0 if gd is None else gd.stride(0),
                None if gw is None else gw.data_ptr(),
                *((0, 0) if gw is None else gw.stride()),
                d_rgb.data_ptr(), d_sigma.data_ptr(), R, K,
                int(bool(white_bkgd)))
        bwd_launches += 1
    return d_rgb.view(SB, B, K, 3), d_sigma.view(SB, B, K)


class _Composite(torch.autograd.Function):
    """Forward: kernel A (CUDA) or the plain composite (CPU). Backward:
    kernel B (CUDA) or ``composite_bwd`` (CPU). Unused outputs hand no
    cotangent (``set_materialize_grads(False)``), so nothing reads zeros."""

    @staticmethod
    def forward(ctx, rgb, sigma, z_samp, rays, white_bkgd):
        ctx.set_materialize_grads(False)
        ctx.white_bkgd = white_bkgd
        ctx.save_for_backward(rgb, sigma, z_samp, rays)
        if rgb.device.type == "cpu":
            return tuple(plain.composite(rgb, sigma, z_samp, rays,
                                         white_bkgd))
        return tuple(composite_kernel(rgb, sigma, z_samp, rays, white_bkgd))

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_w):
        rgb, sigma, z_samp, rays = ctx.saved_tensors
        if g_rgb is None and g_depth is None and g_w is None:
            return None, None, None, None, None
        if rgb.device.type == "cpu":
            if g_rgb is None:
                g_rgb = torch.zeros_like(rgb[..., 0, :])
            d_rgb, d_sigma = plain.composite_bwd(
                rgb, sigma, z_samp, rays[..., 7], g_rgb, g_depth, g_w,
                ctx.white_bkgd)
        else:
            d_rgb, d_sigma = composite_bwd_kernel(
                rgb, sigma, z_samp, rays, g_rgb, g_depth, g_w,
                ctx.white_bkgd)
        return d_rgb, d_sigma, None, None, None


def composite(rgb, sigma, z_samp, rays, white_bkgd: bool = False
              ) -> CompositeOutput:
    """rgb (SB,B,K,3), sigma/z (SB,B,K), rays (SB,B,8) → CompositeOutput,
    differentiable with respect to rgb and sigma."""
    return CompositeOutput(*_Composite.apply(rgb, sigma, z_samp, rays,
                                             bool(white_bkgd)))
