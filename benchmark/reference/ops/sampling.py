"""Depth-guided ray sampling (the DINER flagship op).

Port of ``diner_tpu/ops/sampling.py``'s one-stage sampler: stratified
candidates, three plain lookups of the view maps (depth, std, normal), an
erf-bin surface likelihood, its maximum over views, top-k shortlist, Gaussian
resamples and the closed-form uniform fill-up. Noise is passed in as
arguments, so the same uniforms and normals give the same samples as the
JAX package.

``lax.top_k`` breaks ties by lowest index and ``torch.topk`` promises no
order, so every shortlist is a stable descending sort: the (−value, index)
order of ``lax.top_k``. The likelihoods are mostly exact zeros, so any
other order picks other bins and other samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.geometry.transforms import (
    project_points,
    rotate_to_cam,
    uv_to_ndc,
    world_to_cam,
)
from benchmark.reference.ops.grid_sample import (
    grid_sample_exponential_nearest,
    grid_sample_nearest,
)

SQRT2 = 1.4142135623730951


class ViewMaps(NamedTuple):
    """Per-source-view maps, channels-last:
    depths / depth_stds (SB, NV, H, W, 1), normals (SB, NV, H, W, 3),
    poses (SB, NV, 4, 4), focal / c (SB, NV, 2), image_wh (2,) [W, H]."""

    depths: torch.Tensor
    depth_stds: torch.Tensor
    normals: torch.Tensor
    poses: torch.Tensor
    focal: torch.Tensor
    c: torch.Tensor
    image_wh: torch.Tensor


def stratified_z(rays, n: int, u):
    """Jittered stratified z in [near, far]: rays (SB, NR, 8), u (SB, NR, n)
    uniforms → (SB, NR, n)."""
    near = rays[..., 6:7]
    far = rays[..., 7:8]
    step = 1.0 / n
    base = torch.arange(n, dtype=rays.dtype, device=rays.device) * step
    t = base + u * step
    return near * (1.0 - t) + far * t


def _flatten_views(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def sample_view_maps(views: ViewMaps, uv_ndc):
    """Depth / std / normal at normalized uv (SB, NV, P, 2) by three
    separate lookups → shapes (SB, NV, P, 1/1/3)."""
    SB, NV, P, _ = uv_ndc.shape
    uv = uv_ndc.reshape(SB * NV, P, 2)
    d = grid_sample_nearest(_flatten_views(views.depths), uv, "border")
    s = grid_sample_exponential_nearest(
        _flatten_views(views.depth_stds), uv, pad_size=100, double_width=12.0)
    n = grid_sample_nearest(_flatten_views(views.normals), uv, "zeros")
    return tuple(t.reshape(SB, NV, P, t.shape[-1]) for t in (d, s, n))


def surface_likelihood(rays, views: ViewMaps, z_cand,
                       depth_diff_max: float = 0.05, deform_fn=None):
    """Per-candidate surface likelihood, its maximum over views, and its
    occlusion-aware (transmittance-weighted) variant; both (SB, NR, K).

    deform_fn: None, or a map of the (SB, NR·K, 3) candidate points before
    they are projected (NOVEL's target → observation mesh deformation).
    """
    SB, NR, K = z_cand.shape
    step_size = (rays[..., 7] - rays[..., 6]) / K  # (SB, NR)

    xyz = rays[..., None, :3] + z_cand[..., None] * rays[..., None, 3:6]
    xyz = xyz.reshape(SB, NR * K, 3)
    if deform_fn is not None:
        xyz = deform_fn(xyz)
    xyz_cam = world_to_cam(xyz, views.poses)
    dirs_cam = rotate_to_cam(rays[..., 3:6], views.poses)  # (SB, NV, NR, 3)

    uv = uv_to_ndc(project_points(xyz_cam, views.focal, views.c),
                   views.image_wh)
    ref_depth, ref_std, ref_normal = sample_view_maps(views, uv)
    ref_depth = ref_depth[..., 0]  # (SB, NV, NR*K)
    ref_std = ref_std[..., 0]
    ref_z = xyz_cam[..., 2]

    NV = views.poses.shape[1]
    cos_ray_normal = torch.sum(
        dirs_cam[:, :, :, None, :] * ref_normal.reshape(SB, NV, NR, K, 3),
        dim=-1).reshape(SB, NV, NR * K)
    step = step_size[:, None, :, None].expand(SB, NV, NR, K).reshape(
        SB, NV, NR * K)

    mask = ((ref_std != 0) & (torch.abs(ref_depth - ref_z) < depth_diff_max)
            & (cos_ray_normal <= 0))
    safe_std = torch.where(ref_std == 0, torch.ones_like(ref_std), ref_std)
    upper = torch.erf((ref_z + step / 2 - ref_depth) / (safe_std * SQRT2))
    lower = torch.erf((ref_z - step / 2 - ref_depth) / (safe_std * SQRT2))
    lik = torch.where(mask, 0.5 * torch.abs(upper - lower),
                      torch.zeros_like(upper))
    lik = torch.amax(lik, dim=1).reshape(SB, NR, K)  # max over views

    trans = torch.cumprod(1.0 - lik, dim=-1)
    opaque = lik * torch.cat([torch.ones_like(trans[..., :1]),
                              trans[..., :-1]], dim=-1)
    return lik, opaque


def weighted_mean_std(x, weights, dim=-1, keepdim=True):
    """Weighted mean/std; a zero weight sum gives 0 instead of NaN."""
    wsum = torch.sum(weights, dim=dim, keepdim=True)
    safe = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    wn = weights / safe
    mean = torch.sum(x * wn, dim=dim, keepdim=True)
    std = torch.sqrt(torch.sum((x - mean) ** 2 * wn, dim=dim, keepdim=True))
    valid = wsum != 0
    mean = torch.where(valid, mean, torch.zeros_like(mean))
    std = torch.where(valid, std, torch.zeros_like(std))
    if not keepdim:
        mean, std = mean.squeeze(dim), std.squeeze(dim)
    return mean, std


def top_k_stable(x, k: int):
    """``lax.top_k`` on the last axis: k largest, ties by lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def sample_depthguided(rays, views: ViewMaps, n_samples: int,
                       n_candidates: int, u_coarse, gauss_noise=None,
                       n_gaussian: int = 0, depth_diff_max: float = 0.05,
                       deform_fn=None):
    """Shortlist candidate z values by surface likelihood.

    Args:
      rays: (SB, NR, 8); views: ViewMaps.
      u_coarse: (SB, NR, n_candidates) uniforms for the jitter.
      gauss_noise: (SB, NR, n_gaussian) standard normals (if n_gaussian).
      deform_fn: see :func:`surface_likelihood`.

    Returns:
      (SB, NR, n_samples) z; zero marks an empty slot for
      :func:`fill_up_uniform`.
    """
    if n_samples < n_gaussian:
        raise ValueError(f"n_gaussian={n_gaussian} > n_samples={n_samples}")
    z_cand = stratified_z(rays, n_candidates, u_coarse)
    lik, opaque = surface_likelihood(rays, views, z_cand, depth_diff_max,
                                     deform_fn)

    top_vals, top_idx = top_k_stable(lik, n_samples)
    z_sel = torch.gather(z_cand, -1, top_idx)
    z_sel = torch.where(top_vals == 0.0, torch.zeros_like(z_sel), z_sel)

    if n_gaussian > 0:
        ray_mask = torch.any(opaque != 0, dim=-1)
        mean, std = weighted_mean_std(z_cand, opaque)
        gauss = gauss_noise * std + mean
        gauss = torch.where(ray_mask[..., None], gauss,
                            torch.zeros_like(gauss))
        z_sel = torch.cat([z_sel[..., :-n_gaussian], gauss], dim=-1)
    return z_sel


@torch.no_grad()
def fill_up_uniform(z_samples, rays, u):
    """Fill empty (zero) slots with stratified uniform z, then sort.

    z_samples, u: (SB, NR, S); rays: (SB, NR, 8). Returns ascending z.
    """
    S = z_samples.shape[-1]
    near = rays[..., 6:7]
    far = rays[..., 7:8]
    z_sorted = torch.sort(z_samples, dim=-1).values
    missing = z_sorted == 0.0
    n_missing = missing.sum(dim=-1, keepdim=True).to(z_samples.dtype)
    safe_n = torch.where(n_missing == 0, torch.ones_like(n_missing),
                         n_missing)
    step = (far - near) / safe_n
    idx = torch.arange(S, dtype=z_samples.dtype, device=z_samples.device)
    z_fill = near + idx * step + u * step
    return torch.sort(torch.where(missing, z_fill, z_sorted), dim=-1).values
