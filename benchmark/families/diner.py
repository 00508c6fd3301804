"""DINER: the program's and the reference's model, step and layer spans,
built from a configuration file's sizes.

The program is ``diner_tpu_torch``: its ``PixelNeRF``, ``TrainStep`` and
``make_eval_step``. The reference is ``benchmark/reference``. Both take the
weights the benchmark draws (``benchmark/weights.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import steps as ref_steps
from benchmark.reference.losses.vgg import VGG19Features as RefVGG
from benchmark.reference.models.pixelnerf import (PixelNeRF as RefPixelNeRF,
                                                  PixelNeRFConfig as RefNerf)
from benchmark.reference.nn.spatial_encoder import (
    SpatialEncoderConfig as RefEncoder)
from benchmark.reference.renderer.renderer import (
    RendererConfig as RefRenderer)

NOVEL = False
# the VGG loss convolves in the model's compute dtype
VGG_IN_COMPUTE_DTYPE = True


def nerf_kwargs(c: dict, dtype: str) -> dict:
    return dict(num_freqs=c["num_freqs"], freq_factor=c["freq_factor"],
                include_input=c["include_input"], n_blocks=c["n_blocks"],
                d_hidden=c["d_hidden"], combine_layer=c["combine_layer"],
                compute_dtype=dtype)


def loss_settings(c: dict, mode: str) -> dict:
    m = c[mode]
    keys = ("lr", "w_vgg", "vgg_spatch", "w_antibias",
            "antibias_downsampling")
    return dict({k: m[k] for k in keys if k in m}, znear=c["znear"],
                zfar=c["zfar"])


def program_config(config_cls, nerf, c: dict, mode: str):
    """The program's step configuration (``DinerConfig`` or a subclass)
    for ``mode`` ("train", "render") of configuration ``c``."""
    from diner_tpu_torch.renderer import RendererConfig
    return config_cls(nerf=nerf,
                      renderer=RendererConfig(**c[mode]["renderer"]),
                      **loss_settings(c, mode))


def program(c: dict, mode: str, device):
    """(the program's DinerConfig, its PixelNeRF on ``device``)."""
    from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    from diner_tpu_torch.train.diner import DinerConfig
    nerf = PixelNeRFConfig(encoder=SpatialEncoderConfig(**c["encoder"]),
                           **nerf_kwargs(c, c["compute_dtype"]))
    with torch.device(device):
        model = PixelNeRF(nerf)
    return program_config(DinerConfig, nerf, c, mode), model


def program_vgg(device):
    from diner_tpu_torch.losses.vgg import VGG19Features
    with torch.device(device):
        return VGG19Features()


def program_step(cfg, model, vgg):
    from diner_tpu_torch.train.diner import TrainStep
    return TrainStep(model, cfg, vgg)


def reference(c: dict, mode: str, device, dtype: str):
    """(the reference's PixelNeRF on ``device`` computing in ``dtype``, its
    RendererConfig)."""
    nerf = RefNerf(encoder=RefEncoder(**c["encoder"]),
                   **nerf_kwargs(c, dtype))
    with torch.device(device):
        model = RefPixelNeRF(nerf)
    return model, RefRenderer(**c[mode]["renderer"])


def reference_vgg(device):
    with torch.device(device):
        return RefVGG()


def reference_train_step(model, optimizer, c, rcfg, feed, vgg, block_rays,
                         vgg_dtype):
    return ref_steps.train_step(model, optimizer, loss_settings(c, "train"),
                                rcfg, feed["batch"], vgg, feed["pix"],
                                feed["noise"], block_rays, vgg_dtype,
                                novel=NOVEL)


# ---------------------------------------------------------------- spans


def _sampler(cfg, ctx, rays, noise, deform_fn=None):
    from diner_tpu_torch.ops.sampling import (fill_up_uniform,
                                              sample_depthguided)
    rc = cfg.renderer
    u_coarse, gauss, u_fill = noise
    with torch.no_grad():
        z = sample_depthguided(rays, ctx.view_maps(), rc.n_samples,
                               rc.n_depth_candidates, u_coarse, gauss,
                               rc.n_gaussian, rc.depth_diff_max,
                               deform_fn=deform_fn)
        return fill_up_uniform(z, rays, u_fill)


def _points(rays, z):
    SB, NR, K = z.shape
    pts = (rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
           ).reshape(SB, NR * K, 3)
    dirs = rays[..., None, 3:6].expand(SB, NR, K, 3).reshape(SB, NR * K, 3)
    return pts, dirs


def train_spans(cfg, model, vgg, feed, gen):
    """{span: call} of one training step's layers at the step's shapes,
    each backward with a seeded random cotangent: the encoder forward and
    backward, the sampler and fill-up, the field forward and backward, the
    losses forward and backward."""
    from diner_tpu_torch.losses import antibias_loss, mse_loss, vgg_loss
    from diner_tpu_torch.train.diner import SRC_KEYS, select_rays
    b, dev = feed["batch"], feed["pix"].device
    src = [b[k] for k in SRC_KEYS]
    rays, gt = select_rays(cfg, b, pix_idcs=feed["pix"])
    with torch.no_grad():
        ctx = model.encode(*src)
    g_lat = torch.randn(ctx.latent.shape, generator=gen, device=dev
                        ).to(ctx.latent.dtype)
    z = _sampler(cfg, ctx, rays, feed["noise"])
    pts, dirs = _points(rays, z)
    ctx_g = dataclasses.replace(ctx,
                                latent=ctx.latent.detach().requires_grad_())
    g_field = torch.randn(pts.shape[:2] + (4,), generator=gen, device=dev)
    pred = torch.rand(gt.shape, generator=gen, device=dev).requires_grad_()
    s, SB = cfg.vgg_spatch, gt.shape[0]

    def losses():
        p, t = pred.reshape(SB, -1, s, 3), gt.reshape(SB, -1, s, 3)
        loss = (mse_loss(pred, gt)
                + cfg.w_vgg * vgg_loss(vgg, p, t, dtype=model.dtype)
                + cfg.w_antibias * antibias_loss(p, t,
                                                 cfg.antibias_downsampling))
        loss.backward()

    return {
        "encode": lambda: model.encode(*src, train=True).latent.backward(
            g_lat),
        "sampler": lambda: _sampler(cfg, ctx, rays, feed["noise"]),
        "field": lambda: model.field(ctx_g, pts, dirs).backward(g_field),
        "loss": losses,
    }


def image_spans(cfg, model, feed, chunk_noise):
    """{span: call} of one whole image's sampler and field forward, chunk
    by chunk, as the eval step runs them."""
    from diner_tpu_torch.train.diner import SRC_KEYS, target_rays
    b = feed
    SB, H, W, _ = b["target_rgb"].shape
    with torch.no_grad():
        ctx = model.encode(*(b[k] for k in SRC_KEYS), train=True)
    rays = target_rays(cfg, b, H, W)
    chunk = cfg.renderer.ray_chunk
    n = H * W // chunk
    parts = [rays[:, i * chunk:(i + 1) * chunk].contiguous()
             for i in range(n)]
    zs = [_sampler(cfg, ctx, r, chunk_noise(i)) for i, r in enumerate(parts)]
    pts = [_points(r, z) for r, z in zip(parts, zs)]

    @torch.no_grad()
    def field():
        for p, d in pts:
            model.field(ctx, p, d)

    def sampler():
        for i, r in enumerate(parts):
            _sampler(cfg, ctx, r, chunk_noise(i))

    return {"sampler": sampler, "field": field}
