"""DINER model construction and the full-image eval step.

Port of the eval part of ``diner_tpu/train/diner.py``: ``DinerConfig``
(the fields eval reads), a model constructor that draws its weights from a
seeded ``torch.Generator`` and rerolls dead-density inits
(``diner.py:64-99``), and ``make_eval_step`` (``diner.py:230-271``).
Training comes with the compositing backward kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.geometry.rays import gen_rays
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.renderer import RendererConfig, render_rays_chunked

SRC_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
            "src_intrinsics")


@dataclass(frozen=True)
class DinerConfig:
    nerf: PixelNeRFConfig = dc_field(default_factory=PixelNeRFConfig)
    renderer: RendererConfig = dc_field(default_factory=RendererConfig)
    znear: float = 0.8
    zfar: float = 2.4


def batch_to_device(batch, device) -> dict:
    """Numpy arrays or tensors → tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def target_rays(cfg: DinerConfig, b, H: int, W: int):
    """(SB, H·W, 8) rays of the target cameras in ``b`` (tensors)."""
    SB = b["target_extrinsics"].shape[0]
    dev = b["target_extrinsics"].device
    znear = torch.full((SB,), cfg.znear, device=dev)
    zfar = torch.full((SB,), cfg.zfar, device=dev)
    return gen_rays(b["target_extrinsics"], b["target_intrinsics"], W, H,
                    znear, zfar).reshape(SB, H * W, 8)


def _probe_points(cfg: DinerConfig, b):
    """8 points on each of 64 target rays spread over the image."""
    H, W = (b["target_rgb"].shape[1:3] if "target_rgb" in b
            else b["src_rgbs"].shape[2:4])
    rays = target_rays(cfg, b, H, W)
    rays = rays[:, ::max(H * W // 64, 1)][:, :64]
    SB, n = rays.shape[:2]
    t = torch.linspace(0.05, 0.95, 8, device=rays.device)[:, None]
    xyz = (rays[:, :, None, :3]
           + (rays[:, :, None, 6:7] * (1 - t) + rays[:, :, None, 7:8] * t)
           * rays[:, :, None, 3:6]).reshape(SB, -1, 3)
    dirs = rays[:, :, None, 3:6].expand(SB, n, 8, 3).reshape(SB, -1, 3)
    return xyz, dirs


@torch.no_grad()
def create_model(cfg: DinerConfig, example_batch, seed: int = 0,
                 device=None, max_init_tries: int = 8) -> PixelNeRF:
    """A PixelNeRF with weights drawn from ``torch.Generator(seed)``.

    Inits whose relu density head is non-positive at nearly every probe
    point along real target rays are "dead" (relu∘relu passes no gradient
    and renders only background); they are redrawn, up to
    ``max_init_tries`` times, as the JAX package's ``create_state`` does.
    """
    dev = resolve_device(device)
    b = batch_to_device(example_batch, dev)
    xyz, dirs = _probe_points(cfg, b)
    model = PixelNeRF(cfg.nerf)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(max_init_tries):
        model.cpu().reset_parameters(gen)
        model.to(dev)
        out = model(*(b[k] for k in SRC_KEYS), xyz, dirs)
        if float((out[..., 3] > 0).float().mean()) > 0.01:
            break
    return model


def make_eval_step(model: PixelNeRF, cfg: DinerConfig,
                   use_running_stats: bool = False):
    """Full-image renderer: ``(batch, generator=None, noise=None) →
    (rgb (SB, H, W, 3), depth (SB, H, W))`` on the model's device.

    ``use_running_stats=False`` encodes with batch statistics, as the
    reference's evaluation does, and leaves the running statistics as they
    are. ``noise`` holds whole-image ``(u_coarse, gauss, u_fill)`` arrays
    (see ``render_rays_chunked``); otherwise noise comes from
    ``generator``, which must live on the model's device.
    """

    @torch.no_grad()
    def eval_step(batch, generator=None, noise=None):
        dev = next(model.parameters()).device
        b = batch_to_device(batch, dev)
        SB, H, W, _ = b["target_rgb"].shape
        ctx = model.encode(*(b[k] for k in SRC_KEYS),
                           train=not use_running_stats)
        rays = target_rays(cfg, b, H, W)
        if noise is not None:
            noise = tuple(None if t is None else torch.as_tensor(t).to(dev)
                          for t in noise)
        out = render_rays_chunked(model.field, ctx, rays, cfg.renderer,
                                  noise=noise, generator=generator)
        return out.rgb.reshape(SB, H, W, 3), out.depth.reshape(SB, H, W)

    return eval_step
