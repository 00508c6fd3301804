from diner_tpu_torch.renderer.renderer import (
    RendererConfig,
    RenderOutput,
    draw_noise,
    render_rays,
    render_rays_chunked,
)

__all__ = ["RendererConfig", "RenderOutput", "draw_noise", "render_rays",
           "render_rays_chunked"]
