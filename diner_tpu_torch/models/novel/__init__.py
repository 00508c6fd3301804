"""NOVEL / NOVEL_PE: PixelNeRF with a learnable gen-latent plane and
mesh-offset deformation, its renderer, training step and the dense
keypoint regressor."""

from diner_tpu_torch.models.novel.model import (
    GenContext,
    NovelPixelNeRF,
    NovelPixelNeRFConfig,
    make_gen_context,
)
from diner_tpu_torch.models.novel.renderer import render_rays_novel

__all__ = ["NovelPixelNeRF", "NovelPixelNeRFConfig", "GenContext",
           "make_gen_context", "render_rays_novel"]
