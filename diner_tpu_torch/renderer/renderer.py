"""Depth-guided-sampling volume renderer.

Port of ``diner_tpu/renderer/renderer.py``: depth-guided shortlist (the
one-stage sampler, or the pruned two-stage one when
``n_coarse_candidates > 0``) → uniform fill-up → field evaluation → alpha
compositing. The field is a callable
``field_fn(ctx, xyz, viewdirs) -> (SB, B, 4)``. Noise is either
passed in pre-drawn, as ``(u_coarse, gauss, u_fill)`` with the shapes of
``renderer.py:78-84`` in the JAX package, or drawn from a
``torch.Generator``.

Gradients flow through the field and the compositing; the sampler and the
fill-up run under ``torch.no_grad()``, as the JAX package stops their
gradient. Compositing: on a CUDA tensor both ``composite_impl`` values of
the JAX package ("xla", "pallas") run kernels A and B (forward and
backward); on the CPU they run the plain versions. "torch" runs the plain
forward, differentiated by autograd, on any device: the reference the
kernels are checked against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from diner_tpu_torch.models.scene import SceneContext
from diner_tpu_torch.ops import composite as composite_plain
from diner_tpu_torch.ops import composite_cuda
from diner_tpu_torch.ops.sampling import (check_pruned, fill_up_uniform,
                                          sample_depthguided,
                                          sample_depthguided_pruned)
from diner_tpu_torch.utils import profiling

COMPOSITE_IMPLS = ("xla", "pallas", "torch")


@dataclass(frozen=True)
class RendererConfig:
    n_samples: int = 40
    n_depth_candidates: int = 1000
    n_gaussian: int = 15
    white_bkgd: bool = True
    depth_diff_max: float = 0.05
    # the two-stage sampler (sample_depthguided_pruned): score
    # n_coarse_candidates coarse bins, refine the fine grid inside the top
    # n_refine_bins. 0 = the one-stage sampler
    n_coarse_candidates: int = 0
    n_refine_bins: int = 16
    # rays per chunk for full-image rendering (bounds peak memory)
    ray_chunk: int = 4096
    composite_impl: str = "xla"

    def __post_init__(self):
        if self.composite_impl not in COMPOSITE_IMPLS:
            raise ValueError(f"composite_impl {self.composite_impl!r} not in "
                             f"{COMPOSITE_IMPLS}")
        if self.n_gaussian > self.n_samples:
            raise ValueError("n_gaussian must not exceed n_samples")
        if self.n_coarse_candidates > 0:  # fail here, not mid-render
            check_pruned(self.n_samples, self.n_depth_candidates,
                         self.n_coarse_candidates, self.n_refine_bins,
                         self.n_gaussian)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor                 # (SB, NR, 3)
    depth: torch.Tensor               # (SB, NR)
    weights: Optional[torch.Tensor]   # (SB, NR, K) or None


FieldFn = Callable[[SceneContext, torch.Tensor, torch.Tensor], torch.Tensor]


def draw_noise(cfg: RendererConfig, SB: int, NR: int, generator=None,
               device=None, dtype=torch.float32):
    """Fresh ``(u_coarse, gauss, u_fill)`` for ``NR`` rays."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    u_coarse = torch.rand((SB, NR, cfg.n_depth_candidates), **kw)
    gauss = (torch.randn((SB, NR, cfg.n_gaussian), **kw)
             if cfg.n_gaussian > 0 else None)
    u_fill = torch.rand((SB, NR, cfg.n_samples), **kw)
    return u_coarse, gauss, u_fill


def render_rays(field_fn: FieldFn, ctx: SceneContext, rays,
                cfg: RendererConfig, noise=None, generator=None,
                want_weights: bool = False) -> RenderOutput:
    """Render (SB, NR, 8) rays; ``noise`` = (u_coarse, gauss, u_fill) or
    None to draw it from ``generator``."""
    SB, NR, _ = rays.shape
    with profiling.span("sampler"):
        if noise is None:
            noise = draw_noise(cfg, SB, NR, generator, rays.device,
                               rays.dtype)
        u_coarse, gauss, u_fill = noise
        with torch.no_grad():
            if cfg.n_coarse_candidates > 0:
                z = sample_depthguided_pruned(
                    rays, ctx.view_maps(), cfg.n_samples,
                    cfg.n_depth_candidates, cfg.n_coarse_candidates,
                    cfg.n_refine_bins, u_coarse, gauss, cfg.n_gaussian,
                    cfg.depth_diff_max)
            else:
                z = sample_depthguided(rays, ctx.view_maps(), cfg.n_samples,
                                       cfg.n_depth_candidates, u_coarse,
                                       gauss, cfg.n_gaussian,
                                       cfg.depth_diff_max)
            z = fill_up_uniform(z, rays, u_fill)  # (SB, NR, K) ascending
        K = cfg.n_samples
        points = rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
        viewdirs = rays[..., None, 3:6].expand(points.shape)

    with profiling.span("field"):
        out = field_fn(ctx, points.reshape(SB, NR * K, 3),
                       viewdirs.reshape(SB, NR * K, 3))
        profiling.mark(out, "field")

    with profiling.span("composite"):
        out = out.reshape(SB, NR, K, 4)
        composite = (composite_plain.composite if cfg.composite_impl == "torch"
                     else composite_cuda.composite)
        comp = composite(out[..., :3], out[..., 3], z, rays,
                         white_bkgd=cfg.white_bkgd)
        profiling.mark(comp.rgb, "composite")
    return RenderOutput(rgb=comp.rgb, depth=comp.depth,
                        weights=comp.weights if want_weights else None)


def render_rays_chunked(field_fn: FieldFn, ctx: SceneContext, rays,
                        cfg: RendererConfig, noise=None, generator=None,
                        split=None) -> RenderOutput:
    """Memory-bounded render of many rays (e.g. a full image).

    Pads the ray axis at its edge to a multiple of ``cfg.ray_chunk`` and
    renders one chunk at a time. ``noise`` holds whole-image arrays whose
    ray axis covers at least the NR rays (a shorter tail is edge-padded);
    without it each chunk draws from ``generator``.

    ``split`` shares each chunk out over ranks (``parallel/``'s
    ``RaySplit``): ``rays`` and ``noise`` are the global arrays and the
    draws global; ``ctx`` holds this rank's scenes; each rank renders
    ``split.local`` of the chunk's rays and noise, and ``split.whole``
    brings every rank's part of the output back.
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

    def part(t):
        return t if t is None or split is None else split.local(t)

    rays_p = pad(rays)
    noise_p = None if noise is None else tuple(pad(t) for t in noise)
    rgb, depth = [], []
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        chunk_noise = (draw_noise(cfg, SB, chunk, generator, rays.device,
                                  rays.dtype) if noise_p is None else
                       tuple(None if t is None else t[:, sl]
                             for t in noise_p))
        o = render_rays(field_fn, ctx, part(rays_p[:, sl]).contiguous(), cfg,
                        noise=tuple(part(t) for t in chunk_noise))
        rgb.append(o.rgb if split is None else split.whole(o.rgb))
        depth.append(o.depth if split is None else split.whole(o.depth))
    return RenderOutput(rgb=torch.cat(rgb, dim=1)[:, :NR],
                        depth=torch.cat(depth, dim=1)[:, :NR], weights=None)
