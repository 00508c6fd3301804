"""NeRF sin/cos positional encoding.

Port of ``diner_tpu/nn/positional_encoding.py``, same feature order:
``[x] ++ [sin(f0·x), cos(f0·x), sin(f1·x), ...]``, each row over all input
dims, computed as ``sin(phase + f·x)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PositionalEncoding:
    num_freqs: int = 6
    d_in: int = 3
    freq_factor: float = math.pi
    include_input: bool = True

    @property
    def d_out(self) -> int:
        return self.num_freqs * 2 * self.d_in + (
            self.d_in if self.include_input else 0)

    def __call__(self, x):
        return positional_encode(x, self.num_freqs, self.freq_factor,
                                 self.include_input)


def positional_encode(x, num_freqs: int, freq_factor: float = math.pi,
                      include_input: bool = True):
    """(..., d_in) → (..., d_out)."""
    freqs = freq_factor * (2.0 ** torch.arange(num_freqs, dtype=x.dtype,
                                               device=x.device))
    freqs = torch.repeat_interleave(freqs, 2)  # f0 f0 f1 f1 ...
    phases = torch.zeros(2 * num_freqs, dtype=x.dtype, device=x.device)
    phases[1::2] = 0.5 * math.pi
    emb = torch.sin(phases[:, None] + x[..., None, :] * freqs[:, None])
    emb = emb.reshape(tuple(x.shape[:-1]) + (2 * num_freqs * x.shape[-1],))
    if include_input:
        emb = torch.cat([x, emb], dim=-1)
    return emb
