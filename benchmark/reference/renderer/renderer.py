"""Depth-guided-sampling volume renderer.

Port of ``diner_tpu/renderer/renderer.py`` on the path every cell drives:
the one-stage depth-guided shortlist → uniform fill-up → field evaluation
→ alpha compositing. The field is a callable
``field_fn(ctx, xyz, viewdirs) -> (SB, B, 4)``. Noise is passed in
pre-drawn, as ``(u_coarse, gauss, u_fill)`` with the shapes of
``renderer.py:78-84`` in the JAX package.

Gradients flow through the field and the compositing; the sampler and the
fill-up run under ``torch.no_grad()``, as the JAX package stops their
gradient. Compositing is the plain ``ops/composite.py`` forward,
differentiated by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.models.scene import SceneContext
from benchmark.reference.ops.composite import composite
from benchmark.reference.ops.sampling import (fill_up_uniform,
                                              sample_depthguided)


@dataclass(frozen=True)
class RendererConfig:
    n_samples: int = 40
    n_depth_candidates: int = 1000
    n_gaussian: int = 15
    white_bkgd: bool = True
    depth_diff_max: float = 0.05
    # rays per chunk for full-image rendering (bounds peak memory)
    ray_chunk: int = 4096

    def __post_init__(self):
        if self.n_gaussian > self.n_samples:
            raise ValueError("n_gaussian must not exceed n_samples")


class RenderOutput(NamedTuple):
    rgb: torch.Tensor                 # (SB, NR, 3)
    depth: torch.Tensor               # (SB, NR)


FieldFn = Callable[[SceneContext, torch.Tensor, torch.Tensor], torch.Tensor]


def render_rays(field_fn: FieldFn, ctx: SceneContext, rays,
                cfg: RendererConfig, noise) -> RenderOutput:
    """Render (SB, NR, 8) rays with ``noise`` = (u_coarse, gauss, u_fill)."""
    SB, NR, _ = rays.shape
    u_coarse, gauss, u_fill = noise

    with torch.no_grad():
        z = sample_depthguided(rays, ctx.view_maps(), cfg.n_samples,
                               cfg.n_depth_candidates, u_coarse, gauss,
                               cfg.n_gaussian, cfg.depth_diff_max)
        z = fill_up_uniform(z, rays, u_fill)  # (SB, NR, K) ascending

    K = cfg.n_samples
    points = rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
    viewdirs = rays[..., None, 3:6].expand(points.shape)
    out = field_fn(ctx, points.reshape(SB, NR * K, 3),
                   viewdirs.reshape(SB, NR * K, 3)).reshape(SB, NR, K, 4)
    comp = composite(out[..., :3], out[..., 3], z, rays,
                     white_bkgd=cfg.white_bkgd)
    return RenderOutput(rgb=comp.rgb, depth=comp.depth)


def render_rays_chunked(field_fn: FieldFn, ctx: SceneContext, rays,
                        cfg: RendererConfig, noise) -> RenderOutput:
    """Memory-bounded render of many rays (e.g. a full image).

    Pads the ray axis at its edge to a multiple of ``cfg.ray_chunk`` and
    renders one chunk at a time. ``noise`` holds whole-image arrays whose
    ray axis covers at least the NR rays (a shorter tail is edge-padded).
    """
    SB, NR, _ = rays.shape
    chunk = min(cfg.ray_chunk, NR)
    n_chunks = -(-NR // chunk)
    NRp = n_chunks * chunk

    def pad(t):
        if t is None or t.shape[1] >= NRp:
            return t
        return F.pad(t.transpose(1, 2), (0, NRp - t.shape[1]),
                     mode="replicate").transpose(1, 2)

    rays_p = pad(rays)
    noise_p = tuple(pad(t) for t in noise)
    rgb, depth = [], []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        o = render_rays(field_fn, ctx, rays_p[:, sl].contiguous(), cfg,
                        tuple(None if t is None else t[:, sl]
                              for t in noise_p))
        rgb.append(o.rgb)
        depth.append(o.depth)
    return RenderOutput(rgb=torch.cat(rgb, dim=1)[:, :NR],
                        depth=torch.cat(depth, dim=1)[:, :NR])
