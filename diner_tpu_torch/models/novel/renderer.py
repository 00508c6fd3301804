"""The NOVEL renderer: depth-guided sampling with mesh-offset deformation.

Port of ``diner_tpu/models/novel/renderer.py`` (reference
``src/models/novel/nerf_novel_renderer.py``): the DINER renderer with each
target-space point moved by the offset of its nearest target-mesh vertex
(top-1 kNN, ``ops/knn.py``) before it meets the source views. The sampler
scores deformed candidates; the field is evaluated at the
observation-deformed samples, with the gen-latent plane read at the
canonical-deformed ones. Noise is passed in pre-drawn as ``(u_coarse,
gauss, u_fill)`` with the shapes of the JAX package's draw, or drawn from a
``torch.Generator``. Compositing is the port's: kernels A and B on the card.
"""

from __future__ import annotations

import torch

from diner_tpu_torch.models.novel.model import GenContext
from diner_tpu_torch.models.scene import SceneContext
from diner_tpu_torch.ops import composite as composite_plain
from diner_tpu_torch.ops import composite_cuda
from diner_tpu_torch.ops.knn import deform_points
from diner_tpu_torch.ops.sampling import fill_up_uniform, sample_depthguided
from diner_tpu_torch.renderer.renderer import (RendererConfig, RenderOutput,
                                               draw_noise)
from diner_tpu_torch.utils import profiling


def render_rays_novel(field_fn, ctx: SceneContext, gen: GenContext, rays,
                      target_vertices, offsets_to_source, offsets_to_gen,
                      cfg: RendererConfig, noise=None, generator=None,
                      want_weights: bool = False) -> RenderOutput:
    """Render (SB, NR, 8) rays in target-expression space.

    field_fn: ``(ctx, gen, xyz_obs, xyz_gen, viewdirs) -> (SB, B, 4)``;
    target_vertices (SB, V, 3) the target-expression mesh;
    offsets_to_source / offsets_to_gen (SB, V, 3) per-vertex offsets from
    target space into observation / canonical space. Three kNN calls: the
    sampler's candidates, then the samples twice.
    """
    SB, NR, _ = rays.shape

    def deform_to_source(xyz):
        return deform_points(xyz, target_vertices, offsets_to_source)

    with profiling.span("sampler"):
        if noise is None:
            noise = draw_noise(cfg, SB, NR, generator, rays.device,
                               rays.dtype)
        u_coarse, gauss, u_fill = noise
        with torch.no_grad():
            z = sample_depthguided(rays, ctx.view_maps(), cfg.n_samples,
                                   cfg.n_depth_candidates, u_coarse, gauss,
                                   cfg.n_gaussian, cfg.depth_diff_max,
                                   deform_fn=deform_to_source)
            z = fill_up_uniform(z, rays, u_fill)
        K = cfg.n_samples
        points = (rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
                  ).reshape(SB, NR * K, 3)
        viewdirs = rays[..., None, 3:6].expand(SB, NR, K, 3).reshape(
            SB, NR * K, 3)
        pts_obs = deform_points(points, target_vertices, offsets_to_source)
        pts_gen = deform_points(points, target_vertices, offsets_to_gen)

    with profiling.span("field"):
        out = field_fn(ctx, gen, pts_obs, pts_gen, viewdirs)
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

