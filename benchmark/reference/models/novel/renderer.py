"""The NOVEL renderer: depth-guided sampling with mesh-offset deformation.

Port of ``diner_tpu/models/novel/renderer.py`` (reference
``src/models/novel/nerf_novel_renderer.py``): the DINER renderer with each
target-space point moved by the offset of its nearest target-mesh vertex
(top-1 kNN, ``ops/knn.py``) before it meets the source views. The sampler
scores deformed candidates; the field is evaluated at the
observation-deformed samples, with the gen-latent plane read at the
canonical-deformed ones. Noise is passed in pre-drawn as ``(u_coarse,
gauss, u_fill)`` with the shapes of the JAX package's draw. Compositing is
the plain ``ops/composite.py``.
"""

from __future__ import annotations

import torch

from benchmark.reference.models.novel.model import GenContext
from benchmark.reference.models.scene import SceneContext
from benchmark.reference.ops.composite import composite
from benchmark.reference.ops.knn import deform_points
from benchmark.reference.ops.sampling import (fill_up_uniform,
                                              sample_depthguided)
from benchmark.reference.renderer.renderer import (RendererConfig,
                                                   RenderOutput)


def render_rays_novel(field_fn, ctx: SceneContext, gen: GenContext, rays,
                      target_vertices, offsets_to_source, offsets_to_gen,
                      cfg: RendererConfig, noise) -> RenderOutput:
    """Render (SB, NR, 8) rays in target-expression space.

    field_fn: ``(ctx, gen, xyz_obs, xyz_gen, viewdirs) -> (SB, B, 4)``;
    target_vertices (SB, V, 3) the target-expression mesh;
    offsets_to_source / offsets_to_gen (SB, V, 3) per-vertex offsets from
    target space into observation / canonical space. Three kNN calls: the
    sampler's candidates, then the samples twice.
    """
    SB, NR, _ = rays.shape
    u_coarse, gauss, u_fill = noise

    def deform_to_source(xyz):
        return deform_points(xyz, target_vertices, offsets_to_source)

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

    out = field_fn(ctx, gen, pts_obs, pts_gen, viewdirs).reshape(
        SB, NR, K, 4)
    comp = composite(out[..., :3], out[..., 3], z, rays,
                     white_bkgd=cfg.white_bkgd)
    return RenderOutput(rgb=comp.rgb, depth=comp.depth)

