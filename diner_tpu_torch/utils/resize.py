"""Linear, bicubic and nearest resizes as small matrix products and
repeats.

Port of ``diner_tpu/utils/resize.py`` with port-side copies of its
``_interp_matrix`` (torch ``F.interpolate`` semantics, ``align_corners``
either way) and ``_cubic_matrix`` (Keys a = −0.75,
``align_corners=True``, border-replicated taps). The matrices are cast to
the input dtype, as in the JAX package, so a bf16 pyramid stays bf16 and
rounds its interpolation weights as the reference does.

The JAX functions act on channels-last axes; here each takes the axes it
resizes (``axes``, defaulting to the JAX package's), so the channels-first
MVS model resizes its (N, C, H, W) maps and (B, D, H, W) volumes in place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool = True
                   ) -> np.ndarray:
    """(n_out, n_in) linear interpolation matrix (torch semantics)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 and align_corners:
        A[0, 0] = 1.0
        return A
    if align_corners:
        src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    else:
        scale = n_in / n_out
        src = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0, n_in - 1)
    lo = np.clip(np.floor(src).astype(int), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    w_hi = src - lo
    A[np.arange(n_out), lo] += 1.0 - w_hi
    A[np.arange(n_out), hi] += w_hi
    return A


def resize_bilinear_align_corners(x, out_h: int, out_w: int):
    """Resize channels-last (..., H, W, C) → (..., out_h, out_w, C)."""
    H, W = x.shape[-3], x.shape[-2]
    if (H, W) == (out_h, out_w):
        return x
    Ah = torch.as_tensor(_interp_matrix(H, out_h), dtype=x.dtype,
                         device=x.device)
    Aw = torch.as_tensor(_interp_matrix(W, out_w), dtype=x.dtype,
                         device=x.device)
    x = torch.einsum("oh,...hwc->...owc", Ah, x)
    return torch.einsum("ow,...hwc->...hoc", Aw, x)


@functools.lru_cache(maxsize=64)
def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic (Keys a=-0.75) interpolation matrix,
    align_corners=True, border-replicated taps (torch semantics)."""
    a = -0.75

    def w(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    A = np.zeros((n_out, n_in), dtype=np.float32)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for i in range(n_out):
        src = i * scale
        base = int(np.floor(src))
        for tap in range(base - 1, base + 3):
            A[i, min(max(tap, 0), n_in - 1)] += w(src - tap)
    return A


def resize_bicubic_align_corners(x, out_h: int, out_w: int, axes=(-3, -2)):
    """torch ``F.interpolate(mode='bicubic', align_corners=True)`` of the
    (H, W) ``axes`` (channels-last by default) as two small matrix
    products, H first, as the JAX package computes it."""
    H, W = x.shape[axes[0]], x.shape[axes[1]]
    if (H, W) == (out_h, out_w):
        return x
    for n_in, n_out, axis in ((H, out_h, axes[0]), (W, out_w, axes[1])):
        A = torch.as_tensor(_cubic_matrix(n_in, n_out), dtype=x.dtype,
                            device=x.device)
        x = torch.movedim(torch.einsum("on,...n->...o", A,
                                       torch.movedim(x, axis, -1)), -1, axis)
    return x


def resize_linear_axis(x, out_n: int, axis: int, align_corners: bool = False):
    """1-D linear resize of ``axis`` (torch ``F.interpolate`` semantics)."""
    n_in = x.shape[axis]
    if n_in == out_n:
        return x
    A = torch.as_tensor(_interp_matrix(n_in, out_n, align_corners),
                        dtype=x.dtype, device=x.device)
    x = torch.movedim(x, axis, -1)
    x = torch.einsum("on,...n->...o", A, x)
    return torch.movedim(x, -1, axis)


def resize_linear_2d(x, out_h: int, out_w: int, align_corners: bool = False,
                     axes=(-3, -2)):
    """Bilinear resize of the (H, W) ``axes``: channels-last by default."""
    x = resize_linear_axis(x, out_h, axes[0], align_corners)
    return resize_linear_axis(x, out_w, axes[1], align_corners)


def resize_trilinear(x, out_d: int, out_h: int, out_w: int,
                     align_corners: bool = False, axes=(-4, -3, -2)):
    """Trilinear resize of the (D, H, W) ``axes``: channels-last by
    default."""
    for n, axis in zip((out_d, out_h, out_w), axes):
        x = resize_linear_axis(x, n, axis, align_corners)
    return x


def resize_nearest_2x(x, axes=(-3, -2)):
    """torch ``F.interpolate(scale_factor=2, mode='nearest')`` of the
    (H, W) ``axes``: channels-last by default."""
    for axis in axes:
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x
