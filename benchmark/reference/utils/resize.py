"""The encoder pyramid's bilinear resize (``align_corners=True``) as two
small matrix products.

Port of ``diner_tpu/utils/resize.py``'s ``_interp_matrix`` (torch
``F.interpolate`` semantics) and ``resize_bilinear_align_corners``. The
matrices are cast to the input dtype, as in the JAX package, so a bf16
pyramid stays bf16 and rounds its interpolation weights as there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) linear interpolation matrix, ``align_corners=True``
    (torch semantics)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        A[0, 0] = 1.0
        return A
    src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
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
