"""Residual fully-connected NeRF MLP.

Port of ``diner_tpu/nn/resnetfc.py``: ``n_blocks`` residual FC blocks of
width ``d_hidden``; the latent enters through ``lin_z_i`` before
``combine_layer`` only, where the view axis is averaged. Init as the JAX
initializers: kaiming-normal fan-in weights, zero biases, zero ``fc_1``.
Matrix products run in the compute dtype, parameters stay f32.

Every product's operands have rows that start on multiples of
``ALIGN_BYTES``: cuBLAS runs bf16 products of other rows in Turing-era
``align1`` kernels, and ``F.linear`` adds the bias in a pass of its own to
an input that is not contiguous. So the latent and the point features enter :class:`ResnetFC`
as two tensors, not as slices of one concatenation, and features of a
width whose rows would not align are zero-padded by :func:`cat_aligned`,
each :class:`Dense` padding its cast weight to match.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

ALIGN_BYTES = 16
# Dense calls since the count was last set to 0 whose input or cast weight
# has a row that does not start on a multiple of ALIGN_BYTES (read by the
# tests)
misaligned = 0


def aligned_width(width: int, dtype: torch.dtype) -> int:
    """The least width ≥ ``width`` whose rows of ``dtype`` span a multiple
    of ``ALIGN_BYTES``."""
    n = ALIGN_BYTES // dtype.itemsize
    return -(-width // n) * n


def cat_aligned(parts):
    """``torch.cat(parts, -1)`` with zero columns appended up to
    :func:`aligned_width`: a zero term adds exactly 0 to a product's sums."""
    width = sum(p.shape[-1] for p in parts)
    pad = aligned_width(width, parts[0].dtype) - width
    if pad:
        parts = [*parts, parts[0].new_zeros(parts[0].shape[:-1] + (pad,))]
    return torch.cat(parts, dim=-1)


def _rows_aligned(t) -> bool:
    """Whether every row of ``t`` (its last axis) is unit-strided and starts
    on a multiple of ``ALIGN_BYTES``."""
    size = t.element_size()
    return (t.data_ptr() % ALIGN_BYTES == 0 and t.stride(-1) == 1
            and all(s * size % ALIGN_BYTES == 0
                    for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1))


class Dense(nn.Module):
    """flax ``nn.Dense``: weight stored (out, in) as in ``nn.Linear``. An
    input zero-padded to :func:`aligned_width` by :func:`cat_aligned` meets
    a weight padded with zero columns as wide."""

    def __init__(self, d_in, d_out, bias=True, zero_init=False,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.zero_init, self.dtype = zero_init, dtype

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                std = math.sqrt(2.0 / self.weight.shape[1])
                self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        global misaligned
        dt = self.dtype
        x, w = x.to(dt), self.weight.to(dt)
        d_in = w.shape[1]
        if x.shape[-1] != d_in and x.shape[-1] == aligned_width(d_in, dt):
            w = F.pad(w, (0, x.shape[-1] - d_in))
        if not (_rows_aligned(x) and _rows_aligned(w)):
            misaligned += 1
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x, w, bias)


def _activation(beta: float):
    if beta > 0:
        return lambda t: F.softplus(beta * t) / beta
    return torch.relu


class ResnetBlockFC(nn.Module):
    """x + fc_1(act(fc_0(act(x))))."""

    def __init__(self, size_in, size_h, size_out=None, beta=0.0,
                 dtype=torch.float32):
        super().__init__()
        size_out = size_out or size_in
        self.act = _activation(beta)
        self.fc_0 = Dense(size_in, size_h, dtype=dtype)
        self.fc_1 = Dense(size_h, size_out, zero_init=True, dtype=dtype)
        self.shortcut = (Dense(size_in, size_out, bias=False, dtype=dtype)
                         if size_in != size_out else None)

    def forward(self, x):
        dx = self.fc_1(self.act(self.fc_0(self.act(x))))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + dx


class ResnetFC(nn.Module):
    """The JAX package's ``ResnetFC`` of ``[z, x]`` as ``forward(z, x)``: the
    latent ``z`` (..., d_latent), None without one, and the point features
    ``x`` (..., d_in), or as :func:`cat_aligned` pads them; ``combine_axis``
    (the source-view axis for DINER) is averaged at ``combine_layer``."""

    def __init__(self, d_in, d_out=4, n_blocks=5, d_latent=0, d_hidden=128,
                 beta=0.0, combine_layer=1000, combine_axis=1,
                 dtype=torch.float32):
        super().__init__()
        self.d_latent, self.n_blocks = d_latent, n_blocks
        self.combine_layer, self.combine_axis = combine_layer, combine_axis
        self.act = _activation(beta)
        self.lin_in = Dense(d_in, d_hidden, dtype=dtype)
        self.n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        for i in range(self.n_lin_z):
            setattr(self, f"lin_z_{i}", Dense(d_latent, d_hidden,
                                              dtype=dtype))
        for i in range(n_blocks):
            setattr(self, f"block_{i}", ResnetBlockFC(
                d_hidden, d_hidden, beta=beta, dtype=dtype))
        self.lin_out = Dense(d_hidden, d_out, dtype=dtype)

    def forward(self, z, x):
        x = self.lin_in(x)
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = torch.mean(x, dim=self.combine_axis)
            if blkid < self.n_lin_z:
                x = x + getattr(self, f"lin_z_{blkid}")(z)
            x = getattr(self, f"block_{blkid}")(x)
        return self.lin_out(self.act(x))
