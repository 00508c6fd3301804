"""The plain reference of what the benchmark times: a DINER or NOVEL_PE
training step and a DINER full-image render.

It follows the same mathematics as the program's steps (pixel selection
by given indices, the depth-guided renderer with given noise, MSE + VGG +
antibias on the patch, Adam over every parameter) with plain PyTorch
operations in place of the program's hand-written kernels. To fit
on one card at float32 a training step runs blocked: the encoder once, the
rays' colours in blocks without gradients, the losses and their gradient
with respect to the colours, then each block again with gradients, and
the encoder's backward last with the latent's summed gradient. That is
the gradient of the whole step, computed in parts.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.geometry.rays import gen_rays
from benchmark.reference.losses.basic import antibias_loss, mse_loss
from benchmark.reference.losses.vgg import vgg_loss
from benchmark.reference.models.novel.model import make_gen_context
from benchmark.reference.models.novel.renderer import render_rays_novel
from benchmark.reference.renderer.renderer import (render_rays,
                                                   render_rays_chunked)

SRC_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
            "src_intrinsics")
NOVEL_KEYS = ("target_vertices", "offset_target_to_source",
              "offset_target_to_gen")


def target_rays(znear: float, zfar: float, b, H: int, W: int):
    """(SB, H·W, 8) rays of the target cameras in ``b``."""
    SB = b["target_extrinsics"].shape[0]
    dev = b["target_extrinsics"].device
    return gen_rays(b["target_extrinsics"], b["target_intrinsics"], W, H,
                    torch.full((SB,), znear, device=dev),
                    torch.full((SB,), zfar, device=dev)).reshape(SB, H * W, 8)


def select_rays(znear: float, zfar: float, b, pix_idcs):
    """The rays at flat pixel indices (SB, NR) and their colours."""
    target = b["target_rgb"]
    SB, H, W, _ = target.shape
    rays = target_rays(znear, zfar, b, H, W)
    rays_sel = torch.gather(rays, 1, pix_idcs[..., None].expand(-1, -1, 8))
    gt = torch.gather(target.reshape(SB, H * W, 3), 1,
                      pix_idcs[..., None].expand(-1, -1, 3))
    return rays_sel, gt


def rgb_losses(loss_cfg: dict, rgb, gt, vgg, vgg_dtype):
    """MSE, and with ``w_vgg`` the VGG19 and antibias losses on the square
    patch the rays fill row by row → (total, metrics)."""
    SB = rgb.shape[0]
    total = loss_rgb = mse_loss(rgb, gt)
    metrics = {"rgb_fine": loss_rgb}
    if loss_cfg["w_vgg"] > 0:
        s = loss_cfg["vgg_spatch"]
        pred_img, gt_img = rgb.reshape(SB, -1, s, 3), gt.reshape(SB, -1, s, 3)
        loss_vgg = vgg_loss(vgg, pred_img, gt_img, dtype=vgg_dtype)
        total = total + loss_cfg["w_vgg"] * loss_vgg
        metrics["vgg_fine"] = loss_vgg
        if loss_cfg["w_antibias"] > 0:
            loss_ab = antibias_loss(pred_img, gt_img,
                                    loss_cfg["antibias_downsampling"])
            total = total + loss_cfg["w_antibias"] * loss_ab
            metrics["antibias"] = loss_ab
    metrics["total"] = total
    return total, metrics


def train_step(model, optimizer, loss_cfg: dict, rcfg, b, vgg, pix_idcs,
               noise, block_rays: int, vgg_dtype=torch.float32,
               novel: bool = False) -> dict:
    """One Adam step of the model on batch ``b`` with the given pixels and
    renderer noise ``(u_coarse, gauss, u_fill)`` → the step's losses.
    ``novel`` renders with the mesh deformation and the gen-latent plane.
    After the call each parameter's ``.grad`` holds the step's gradient."""
    optimizer.zero_grad(set_to_none=True)
    SB, H, W, _ = b["target_rgb"].shape
    ctx = model.encode(*(b[k] for k in SRC_KEYS), train=True,
                       update_stats=True)
    latent = ctx.latent
    leaf = latent.detach().requires_grad_()
    ctx = dataclasses.replace(ctx, latent=leaf)
    rays, gt = select_rays(loss_cfg["znear"], loss_cfg["zfar"], b, pix_idcs)
    gen = None
    if novel:
        use_pe = model.cfg.use_pe_maps and "target_pos_encoding" in b
        gen = make_gen_context(
            b["gen_extrinsics"], b["gen_intrinsics"], (W, H),
            src_pe_maps=b.get("src_pos_encodings"),
            tgt_pe_map=b["target_pos_encoding"][:, None] if use_pe else None)

    def render(sl):
        part = tuple(None if t is None else t[:, sl] for t in noise)
        r = rays[:, sl].contiguous()
        if novel:
            return render_rays_novel(model.field, ctx, gen, r,
                                     *(b[k] for k in NOVEL_KEYS), rcfg,
                                     part).rgb
        return render_rays(model.field, ctx, r, rcfg, part).rgb

    NR = rays.shape[1]
    blocks = [slice(i, i + block_rays) for i in range(0, NR, block_rays)]
    with torch.no_grad():
        rgb = torch.cat([render(sl) for sl in blocks], dim=1)
    rgb.requires_grad_()
    total, metrics = rgb_losses(loss_cfg, rgb, gt, vgg, vgg_dtype)
    total.backward()
    for sl in blocks:
        render(sl).backward(rgb.grad[:, sl])
    latent.backward(leaf.grad)
    for p in model.parameters():  # every parameter takes Adam's step
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def render_image(model, rcfg, znear: float, zfar: float, b, noise):
    """Whole target images of ``b`` with batch statistics and the given
    whole-image noise → (rgb (SB, H, W, 3), depth (SB, H, W))."""
    SB, H, W, _ = b["target_rgb"].shape
    ctx = model.encode(*(b[k] for k in SRC_KEYS), train=True)
    out = render_rays_chunked(model.field, ctx,
                              target_rays(znear, zfar, b, H, W), rcfg,
                              noise)
    return out.rgb.reshape(SB, H, W, 3), out.depth.reshape(SB, H, W)
