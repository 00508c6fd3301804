"""NOVEL / NOVEL_PE: DINER's field with the gen-latent plane, the mesh
deformation (top-1 kNN) and, with ``use_pe_maps``, the PE-map deformation
layer; the program's ``NovelPixelNeRF`` and ``NovelTrainStep`` beside the
reference's. The VGG loss runs in float32, as the program's NOVEL step
runs it."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.families import diner
from benchmark.families.diner import (loss_settings, nerf_kwargs,
                                      program_config, program_vgg,
                                      reference_vgg)
from benchmark.reference import steps as ref_steps
from benchmark.reference.models.novel.model import (
    NovelPixelNeRF as RefNovel, NovelPixelNeRFConfig as RefNovelCfg)
from benchmark.reference.nn.spatial_encoder import (
    SpatialEncoderConfig as RefEncoder)
from benchmark.reference.renderer.renderer import (
    RendererConfig as RefRenderer)

__all__ = ["program", "program_vgg", "program_step", "reference",
           "reference_vgg", "reference_train_step", "train_spans"]
NOVEL = True
VGG_IN_COMPUTE_DTYPE = False


def _novel_kwargs(c):
    return dict(gen_latent_hw=c["gen_latent_hw"],
                gen_latent_ch=c["gen_latent_ch"],
                use_pe_maps=c["use_pe_maps"])


def program(c: dict, mode: str, device):
    from diner_tpu_torch.models.novel.model import (NovelPixelNeRF,
                                                    NovelPixelNeRFConfig)
    from diner_tpu_torch.models.novel.train import NovelConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    nerf = NovelPixelNeRFConfig(
        encoder=SpatialEncoderConfig(**c["encoder"]),
        **nerf_kwargs(c, c["compute_dtype"]), **_novel_kwargs(c))
    with torch.device(device):
        model = NovelPixelNeRF(nerf)
    return program_config(NovelConfig, nerf, c, mode), model


def program_step(cfg, model, vgg):
    from diner_tpu_torch.models.novel.train import NovelTrainStep
    return NovelTrainStep(model, cfg, vgg)


def reference(c: dict, mode: str, device, dtype: str):
    nerf = RefNovelCfg(encoder=RefEncoder(**c["encoder"]),
                       **nerf_kwargs(c, dtype), **_novel_kwargs(c))
    with torch.device(device):
        model = RefNovel(nerf)
    return model, RefRenderer(**c[mode]["renderer"])


def reference_train_step(model, optimizer, c, rcfg, feed, vgg, block_rays,
                         vgg_dtype):
    return ref_steps.train_step(model, optimizer, loss_settings(c, "train"),
                                rcfg, feed["batch"], vgg, feed["pix"],
                                feed["noise"], block_rays, vgg_dtype,
                                novel=NOVEL)


def train_spans(cfg, model, vgg, feed, gen):
    """As ``diner.train_spans``: the sampler deforms its candidates through
    the kNN; the field takes the deformed points and the gen context."""
    from diner_tpu_torch.losses import antibias_loss, mse_loss, vgg_loss
    from diner_tpu_torch.models.novel.train import NOVEL_KEYS, gen_context_of
    from diner_tpu_torch.ops.knn import deform_points
    from diner_tpu_torch.train.diner import SRC_KEYS, select_rays
    b, dev = feed["batch"], feed["pix"].device
    SB, H, W, _ = b["target_rgb"].shape
    src = [b[k] for k in SRC_KEYS]
    verts, to_src, to_gen = (b[k] for k in NOVEL_KEYS)
    rays, gt = select_rays(cfg, b, pix_idcs=feed["pix"])
    gen_ctx = gen_context_of(model, b, W, H)
    with torch.no_grad():
        ctx = model.encode(*src)
    g_lat = torch.randn(ctx.latent.shape, generator=gen, device=dev
                        ).to(ctx.latent.dtype)

    def deform(xyz):
        return deform_points(xyz, verts, to_src)

    def sampler():
        z = diner._sampler(cfg, ctx, rays, feed["noise"], deform_fn=deform)
        pts, dirs = diner._points(rays, z)
        with torch.no_grad():
            return (deform_points(pts, verts, to_src),
                    deform_points(pts, verts, to_gen), dirs)

    obs, can, dirs = sampler()
    ctx_g = dataclasses.replace(ctx,
                                latent=ctx.latent.detach().requires_grad_())
    g_field = torch.randn(obs.shape[:2] + (4,), generator=gen, device=dev)
    pred = torch.rand(gt.shape, generator=gen, device=dev).requires_grad_()
    s = cfg.vgg_spatch

    def losses():
        p, t = pred.reshape(SB, -1, s, 3), gt.reshape(SB, -1, s, 3)
        loss = (mse_loss(pred, gt) + cfg.w_vgg * vgg_loss(vgg, p, t)
                + cfg.w_antibias * antibias_loss(p, t,
                                                 cfg.antibias_downsampling))
        loss.backward()

    return {
        "encode": lambda: model.encode(*src, train=True).latent.backward(
            g_lat),
        "sampler": sampler,
        "field": lambda: model.field(ctx_g, gen_ctx, obs, can, dirs
                                     ).backward(g_field),
        "loss": losses,
    }
