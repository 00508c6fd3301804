"""Residual fully-connected NeRF MLP.

Port of ``diner_tpu/nn/resnetfc.py``: ``n_blocks`` residual FC blocks of
width ``d_hidden``; the latent enters through ``lin_z_i`` before
``combine_layer`` only, where the view axis is averaged. ReLU
activations. Matrix products run in the compute dtype, parameters stay
f32; the benchmark draws every weight (``benchmark/weights.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import round_input


class Dense(nn.Module):
    """flax ``nn.Dense``: weight stored (out, in) as in ``nn.Linear``."""

    def __init__(self, d_in, d_out, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(round_input(x.to(dt)), round_input(self.weight.to(dt)),
                        self.bias.to(dt))


class ResnetBlockFC(nn.Module):
    """x + fc_1(relu(fc_0(relu(x))))."""

    def __init__(self, size, dtype=torch.float32):
        super().__init__()
        self.fc_0 = Dense(size, size, dtype=dtype)
        self.fc_1 = Dense(size, size, dtype=dtype)

    def forward(self, x):
        return x + self.fc_1(torch.relu(self.fc_0(torch.relu(x))))


class ResnetFC(nn.Module):
    """Input last axis is ``[latent (d_latent), x (d_in)]``; ``combine_axis``
    (the source-view axis for DINER) is averaged at ``combine_layer``."""

    def __init__(self, d_in, d_out=4, n_blocks=5, d_latent=0, d_hidden=128,
                 combine_layer=1000, combine_axis=1, dtype=torch.float32):
        super().__init__()
        self.d_latent, self.n_blocks = d_latent, n_blocks
        self.combine_layer, self.combine_axis = combine_layer, combine_axis
        self.lin_in = Dense(d_in, d_hidden, dtype=dtype)
        self.n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        for i in range(self.n_lin_z):
            setattr(self, f"lin_z_{i}", Dense(d_latent, d_hidden,
                                              dtype=dtype))
        for i in range(n_blocks):
            setattr(self, f"block_{i}", ResnetBlockFC(d_hidden, dtype))
        self.lin_out = Dense(d_hidden, d_out, dtype=dtype)

    def forward(self, zx):
        z = zx[..., :self.d_latent] if self.d_latent > 0 else None
        x = self.lin_in(zx[..., self.d_latent:])
        for blkid in range(self.n_blocks):
            if blkid == self.combine_layer:
                x = torch.mean(x, dim=self.combine_axis)
            if blkid < self.n_lin_z:
                x = x + getattr(self, f"lin_z_{blkid}")(z)
            x = getattr(self, f"block_{blkid}")(x)
        return self.lin_out(torch.relu(x))
