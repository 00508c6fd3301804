"""DINER model construction, the training step and the full-image eval
step.

Port of ``diner_tpu/train/diner.py``: ``DinerConfig``, a model constructor
that draws its weights from a seeded ``torch.Generator`` and rerolls
dead-density inits (``diner.py:64-99``), ``select_pixels`` and
``compute_losses`` (``:120-203``), ``make_train_step`` (``:206-227``) and
``make_eval_step`` (``:230-271``). A ResNet34 encoder takes converted
ImageNet weights where they are on disk (``utils/pretrained.py``).

Per train step: encode the source views with batch statistics (and move
the running ones), select 128 random pixels or, with the VGG loss on, a
64×64 patch whose centre is drawn on the foreground mask, render them,
take MSE + VGG + antibias losses and step Adam over every parameter of the
model. Random draws come from an explicit ``torch.Generator``; a caller
may pass the pixel indices and the renderer's noise instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.geometry.rays import gen_rays
from diner_tpu_torch.losses import antibias_loss, mse_loss, vgg_loss
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.renderer import (RendererConfig, draw_noise,
                                      render_rays, render_rays_chunked)
from diner_tpu_torch.utils import profiling
from diner_tpu_torch.utils.pretrained import (graft_resnet34,
                                              load_resnet34_variables)

SRC_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
            "src_intrinsics")


@dataclass(frozen=True)
class DinerConfig:
    nerf: PixelNeRFConfig = dc_field(default_factory=PixelNeRFConfig)
    renderer: RendererConfig = dc_field(default_factory=RendererConfig)
    znear: float = 0.8
    zfar: float = 2.4
    ray_batch_size: int = 128
    lr: float = 1e-4
    w_vgg: float = 0.0
    vgg_spatch: int = 64
    w_antibias: float = 0.0
    antibias_downsampling: int = 3

    @property
    def rays_per_step(self) -> int:
        # the VGG loss needs a square patch
        return self.vgg_spatch ** 2 if self.w_vgg != 0 else self.ray_batch_size


def batch_to_device(batch, device) -> dict:
    """Numpy arrays or tensors → tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


def noise_to_device(noise, device):
    """Pre-drawn ``(u_coarse, gauss, u_fill)`` (arrays or tensors; gauss
    may be None) → tensors on ``device``; None stays None."""
    if noise is None:
        return None
    return tuple(None if t is None else torch.as_tensor(t).to(device)
                 for t in noise)


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
    Then, as there (``diner.py:100-108``), a ResNet34 encoder takes the
    converted ImageNet weights where ``utils/pretrained.py`` finds them.
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
    if cfg.nerf.encoder.backbone == "resnet34":
        # the reference loads torchvision's pretrained=True
        # (src/models/image_encoder.py:50-56)
        pre = load_resnet34_variables()
        if pre is not None:
            graft_resnet34(model, pre)
    return model


def select_pixels(cfg: DinerConfig, b, generator=None):
    """(SB, rays_per_step) flat pixel indices into H·W (``diner.py:120-146``).

    Without the VGG loss: uniform random pixels. With it: a
    ``vgg_spatch``² patch whose centre is drawn with probability
    proportional to ``target_alpha``, borders of ``(spatch + 1) // 2``
    excluded. ``generator`` lives on the batch's device.
    """
    SB, H, W, _ = b["target_rgb"].shape
    dev = b["target_rgb"].device
    if cfg.w_vgg == 0.0:
        return torch.randint(0, H * W, (SB, cfg.rays_per_step),
                             generator=generator, device=dev)
    spatch = cfg.vgg_spatch
    pad = (spatch + 1) // 2
    fg = b["target_alpha"][..., 0].float().clone()
    fg[:, :, :pad] = 0
    fg[:, :pad, :] = 0
    fg[:, :, -pad:] = 0
    fg[:, -pad:, :] = 0
    centers = torch.multinomial(fg.reshape(SB, H * W), 1,
                                generator=generator)[:, 0]
    cx, cy = centers % W, centers // W
    d = torch.arange(spatch, device=dev)
    px = cx[:, None, None] + d[None, None, :] - pad  # (SB, s, s)
    py = cy[:, None, None] + d[None, :, None] - pad
    return (px + py * W).reshape(SB, spatch * spatch)


def compute_losses(model: PixelNeRF, cfg: DinerConfig, b, vgg=None,
                   generator=None, noise=None, pix_idcs=None,
                   update_stats: bool = False, mesh=None):
    """Forward and all losses of one step (``diner.py:149-203``) on the
    tensors ``b`` → (total, metrics).

    ``pix_idcs`` (SB, rays_per_step) and ``noise`` (the renderer's
    ``(u_coarse, gauss, u_fill)``) are drawn from ``generator`` when not
    given, in that order. ``update_stats`` moves the BN running statistics.

    With a ``mesh`` (``parallel/``) ``b`` and the draws are global and this
    rank computes its block of the step (``diner.py:173-177`` splits the
    rays so): its scenes, with BN statistics over every rank's scenes; its
    rays, with the VGG patch gathered whole. ``total`` is then this rank's
    share of the loss (the sum over ranks is the global one), and the
    metrics are the global values.
    """
    local, stats_mean = b, None
    if mesh is not None:
        from diner_tpu_torch.parallel import sharding
        local, stats_mean = sharding.shard_batch(b, mesh), \
            sharding.batch_mean(mesh)
    with profiling.span("encode"):
        ctx = model.encode(*(local[k] for k in SRC_KEYS), train=True,
                           update_stats=update_stats, stats_mean=stats_mean)
        profiling.mark(ctx.latent, "encode")
    if pix_idcs is None:
        pix_idcs = select_pixels(cfg, b, generator)
    rays_sel, gt = select_rays(cfg, local, pix_idcs=(
        pix_idcs if mesh is None else sharding.ray_slice(pix_idcs, mesh)))
    if noise is None:
        noise = draw_noise(cfg.renderer, *pix_idcs.shape, generator,
                           rays_sel.device, rays_sel.dtype)
    if mesh is not None:
        noise = tuple(None if t is None else sharding.ray_slice(t, mesh)
                      for t in noise)
    rgb = render_rays(model.field, ctx, rays_sel, cfg.renderer,
                      noise=noise).rgb
    with profiling.span("loss"):
        if mesh is not None and cfg.w_vgg > 0:
            # the patch terms convolve the whole patch
            rgb = sharding.gather_rays(rgb, mesh)
            gt = sharding.gather_rays(gt, mesh)
        total, metrics = rgb_losses(cfg, rgb, gt, vgg, vgg_dtype=model.dtype)
        if mesh is not None:
            # every rank holds as many rays and every rank of a ray group
            # the same patch terms: 1 / ranks of each is its share of the
            # global mean
            share = 1.0 / mesh.size
            total, metrics = total * share, sharding.reduce_metrics(
                {k: v * share for k, v in metrics.items()}, mesh)
        profiling.mark(total, "loss")
    return total, metrics


def select_rays(cfg: DinerConfig, b, generator=None, pix_idcs=None):
    """The step's target rays (SB, rays_per_step, 8) and their ground-truth
    colours (SB, rays_per_step, 3); ``pix_idcs`` drawn from ``generator``
    when not given."""
    target = b["target_rgb"]
    SB, H, W, _ = target.shape
    rays = target_rays(cfg, b, H, W)
    if pix_idcs is None:
        pix_idcs = select_pixels(cfg, b, generator)
    rays_sel = torch.gather(rays, 1, pix_idcs[..., None].expand(-1, -1, 8))
    gt = torch.gather(target.reshape(SB, H * W, 3), 1,
                      pix_idcs[..., None].expand(-1, -1, 3))
    return rays_sel, gt


def rgb_losses(cfg: DinerConfig, rgb, gt, vgg=None,
               vgg_dtype=torch.float32):
    """MSE, and with ``w_vgg`` the VGG19 and antibias losses on the
    ``vgg_spatch``² patch (``diner.py:177-203``) → (total, metrics);
    ``vgg_dtype`` is the VGG convolutions' compute dtype. The rays are the
    patch's pixels row by row; the patch is as many rows as they fill."""
    SB = rgb.shape[0]
    loss_rgb = mse_loss(rgb, gt)
    total = loss_rgb
    metrics = {"rgb_fine": loss_rgb}
    if cfg.w_vgg > 0:
        s = cfg.vgg_spatch
        pred_img = rgb.reshape(SB, -1, s, 3)
        gt_img = gt.reshape(SB, -1, s, 3)
        loss_vgg = vgg_loss(vgg, pred_img, gt_img, dtype=vgg_dtype)
        total = total + cfg.w_vgg * loss_vgg
        metrics["vgg_fine"] = loss_vgg
        if cfg.w_antibias > 0:
            loss_ab = antibias_loss(pred_img, gt_img,
                                    cfg.antibias_downsampling)
            total = total + cfg.w_antibias * loss_ab
            metrics["antibias"] = loss_ab
    metrics["total"] = total
    return total, metrics


class TrainStep:
    """One optimizer step per call: ``(batch, generator=None, noise=None,
    pix_idcs=None) → metrics`` (0-d tensors on the model's device).

    Holds ``optimizer``, an Adam over every parameter of the model (the
    running statistics are buffers, outside it), and ``step``, the count
    of steps taken. After a call each parameter's ``.grad`` holds the
    step's gradient. ``loss_fn`` is the step's forward and losses, and
    ``complete_gradients`` runs between the backward and Adam.
    """

    loss_fn = staticmethod(compute_losses)

    def __init__(self, model: PixelNeRF, cfg: DinerConfig, vgg=None):
        if cfg.w_vgg > 0 and vgg is None:
            raise ValueError("w_vgg > 0 needs a VGG19Features (init_vgg19)")
        self.model, self.cfg, self.vgg = model, cfg, vgg
        self.optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
        self.step = 0

    def __call__(self, batch, generator=None, noise=None, pix_idcs=None):
        dev = next(self.model.parameters()).device
        with profiling.span("train_step", dev):
            b = batch_to_device(batch, dev)
            noise = noise_to_device(noise, dev)
            if pix_idcs is not None:
                pix_idcs = torch.as_tensor(pix_idcs).to(dev)
            with profiling.span("optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            total, metrics = self.loss_fn(self.model, self.cfg, b, self.vgg,
                                          generator, noise, pix_idcs,
                                          update_stats=True)
            with profiling.span("backward"):
                total.backward()
            with profiling.span("optimizer"):
                self.complete_gradients()
                self.optimizer.step()
            self.step += 1
            return {k: v.detach() for k, v in metrics.items()}

    def complete_gradients(self):
        """Give every parameter a gradient: optax steps every parameter,
        zero or not."""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(model: PixelNeRF, cfg: DinerConfig,
                    vgg=None) -> TrainStep:
    """The train step on the model's device (``cuda`` unless the model was
    created with ``device="cpu"``); ``vgg`` is needed when ``w_vgg > 0``."""
    return TrainStep(model, cfg, vgg)


def make_eval_step(model: PixelNeRF, cfg: DinerConfig,
                   use_running_stats: bool = False, mesh=None):
    """Full-image renderer: ``(batch, generator=None, noise=None) →
    (rgb (SB, H, W, 3), depth (SB, H, W))`` on the model's device.

    ``use_running_stats=False`` encodes with batch statistics, as the
    reference's evaluation does, and leaves the running statistics as they
    are. ``noise`` holds whole-image ``(u_coarse, gauss, u_fill)`` arrays
    (see ``render_rays_chunked``); otherwise noise comes from
    ``generator``, which must live on the model's device. With a ``mesh``
    (``parallel/``) every rank takes the global batch, encodes its scenes
    (batch statistics over every rank's), renders its part of each chunk
    and returns the whole image.
    """

    @torch.no_grad()
    def eval_step(batch, generator=None, noise=None):
        dev = next(model.parameters()).device
        with profiling.span("eval_image", dev):
            b = batch_to_device(batch, dev)
            SB, H, W, _ = b["target_rgb"].shape
            local, stats_mean, split = b, None, None
            if mesh is not None:
                from diner_tpu_torch.parallel import sharding
                local = sharding.shard_batch(b, mesh)
                stats_mean = sharding.batch_mean(mesh)
                split = sharding.RaySplit(mesh, SB)
            with profiling.span("encode"):
                ctx = model.encode(*(local[k] for k in SRC_KEYS),
                                   train=not use_running_stats,
                                   stats_mean=stats_mean)
            rays = target_rays(cfg, b, H, W)
            noise = noise_to_device(noise, dev)
            out = render_rays_chunked(model.field, ctx, rays, cfg.renderer,
                                      noise=noise, generator=generator,
                                      split=split)
            return (out.rgb.reshape(SB, H, W, 3),
                    out.depth.reshape(SB, H, W))

    return eval_step
