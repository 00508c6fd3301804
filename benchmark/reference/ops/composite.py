"""Alpha-compositing volume integration — the plain PyTorch version.

Port of ``diner_tpu/ops/composite.py``: deltas with a tail to ``far``,
α = 1 − exp(−δ·relu σ), transmittance cumprod with the 1e-10 floor,
weighted rgb/depth sums, optional white background; differentiated by
autograd. The plain operation in place of the program's hand-written
composite kernels (A forward, B backward).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor      # (SB, B, 3)
    depth: torch.Tensor    # (SB, B)
    weights: torch.Tensor  # (SB, B, K)


def composite(rgb, sigma, z_samp, rays, white_bkgd: bool = False):
    """Integrate per-sample radiance along rays.

    Args:
      rgb: (SB, B, K, 3) sigmoid-activated colour.
      sigma: (SB, B, K) density (relu applied here).
      z_samp: (SB, B, K) ascending sample depths.
      rays: (SB, B, 8); only [..., 7] (far) is read.
      white_bkgd: add (1 − Σw) to the colour.
    """
    _, alphas = _deltas_alphas(sigma, z_samp, rays[..., 7])
    shifted = torch.cat([torch.ones_like(alphas[..., :1]),
                         1.0 - alphas + 1e-10], dim=-1)
    transmittance = torch.cumprod(shifted, dim=-1)
    weights = alphas * transmittance[..., :-1]

    rgb_final = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_final = torch.sum(weights * z_samp, dim=-1)
    if white_bkgd:
        rgb_final = rgb_final + (1.0 - torch.sum(weights, dim=-1))[..., None]
    return CompositeOutput(rgb=rgb_final, depth=depth_final, weights=weights)


def _deltas_alphas(sigma, z_samp, far):
    deltas = torch.cat([z_samp[..., 1:] - z_samp[..., :-1],
                        far[..., None] - z_samp[..., -1:]], dim=-1)
    return deltas, 1.0 - torch.exp(-deltas * torch.relu(sigma))
