"""Alpha-compositing volume integration — the plain PyTorch version.

Port of ``diner_tpu/ops/composite.py``: deltas with a tail to ``far``,
α = 1 − exp(−δ·relu σ), transmittance cumprod with the 1e-10 floor,
weighted rgb/depth sums, optional white background. ``composite_bwd`` is
the hand-written VJP of the Pallas kernel
(``diner_tpu/ops/pallas/composite_pallas.py:_bwd_kernel``). Both are the
plain versions of the CUDA kernels in ``ops/composite_cuda.py`` and what
that wrapper runs for tensors on the CPU.
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


def composite_bwd(rgb, sigma, z_samp, far, g_rgb, g_depth=None, g_w=None,
                  white_bkgd: bool = False):
    """VJP of :func:`composite` with respect to rgb and sigma.

    Recomputes α_k and T_k, then with dL/dw_k = c_k·g_rgb + z_k·g_depth +
    g_w_k (− Σg_rgb with a white background) and the reverse suffix
    S_k = Σ_{j>k} dL/dw_j·w_j:
      dL/dα_k = T_k·dL/dw_k − S_k / (1 − α_k + 1e-10)
      dσ_k = dL/dα_k · δ_k·exp(−δ_k·relu σ_k) · [σ_k > 0],  d_rgb_k = w_k·g_rgb
    z and far get no gradient (the sampler stops it).

    Args: rgb (..., K, 3); sigma, z_samp (..., K); far (...,); g_rgb
    (..., 3); g_depth (...,) and g_w (..., K), each None for zero.
    Returns (d_rgb (..., K, 3), d_sigma (..., K)).
    """
    deltas, alphas = _deltas_alphas(sigma, z_samp, far)
    shifted = 1.0 - alphas + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(shifted[..., :1]),
                                     shifted[..., :-1]], dim=-1), dim=-1)
    weights = alphas * trans
    dldw = torch.sum(rgb * g_rgb[..., None, :], dim=-1)
    if g_depth is not None:
        dldw = dldw + z_samp * g_depth[..., None]
    if g_w is not None:
        dldw = dldw + g_w
    if white_bkgd:
        dldw = dldw - torch.sum(g_rgb, dim=-1, keepdim=True)
    # Σ_{j≥k} summed from the last sample down, as the Pallas kernel does;
    # shifted by one sample it is Σ_{j>k}
    inclusive = torch.flip(torch.cumsum(torch.flip(dldw * weights, [-1]),
                                        dim=-1), [-1])
    suffix = torch.cat([inclusive[..., 1:],
                        torch.zeros_like(inclusive[..., :1])], dim=-1)
    dlda = trans * dldw - suffix / shifted
    d_sigma = (dlda * (deltas * torch.exp(-deltas * torch.relu(sigma)))
               * (sigma > 0))
    return weights[..., None] * g_rgb[..., None, :], d_sigma
