"""The NOVEL / NOVEL_PE training step and its training loop.

Port of ``diner_tpu/models/novel/train.py`` (reference
``src/models/novel/novel.py``): the DINER recipe (pixel or patch ray
selection, MSE + VGG + antibias) with the NOVEL renderer. Each step encodes
the source views with batch statistics (and moves the running ones), packs
the canonical "gen" camera (and, for NOVEL_PE, the PE maps), renders the
selected rays with the target mesh's deformation offsets and steps one
Adam over every parameter, the gen-latent plane included. As in the JAX
package, the weights are a plain seeded draw: no dead-density reroll and no
pretrained ResNet34.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field

import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.models.novel.model import (NovelPixelNeRF,
                                                NovelPixelNeRFConfig,
                                                make_gen_context)
from diner_tpu_torch.models.novel.renderer import render_rays_novel
from diner_tpu_torch.train.diner import (SRC_KEYS, DinerConfig, TrainStep,
                                         rgb_losses, select_rays)
from diner_tpu_torch.utils import profiling

NOVEL_KEYS = ("target_vertices", "offset_target_to_source",
              "offset_target_to_gen")


@dataclass(frozen=True)
class NovelConfig(DinerConfig):
    nerf: NovelPixelNeRFConfig = dc_field(
        default_factory=NovelPixelNeRFConfig)


def create_novel_model(cfg: NovelConfig, seed: int = 0,
                       device=None) -> NovelPixelNeRF:
    """A NOVEL model with every weight drawn from ``torch.Generator(seed)``,
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model = NovelPixelNeRF(cfg.nerf)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev)


def gen_context_of(model: NovelPixelNeRF, b, W: int, H: int):
    """The batch's canonical camera, with the PE maps for NOVEL_PE."""
    use_pe = model.cfg.use_pe_maps and "target_pos_encoding" in b
    return make_gen_context(
        b["gen_extrinsics"], b["gen_intrinsics"], (W, H),
        src_pe_maps=b.get("src_pos_encodings"),
        tgt_pe_map=b["target_pos_encoding"][:, None] if use_pe else None)


def compute_novel_losses(model: NovelPixelNeRF, cfg: NovelConfig, b,
                         vgg=None, generator=None, noise=None, pix_idcs=None,
                         update_stats: bool = False):
    """Forward and losses of one NOVEL step on the tensors ``b`` →
    (total, metrics) (``train.py:73-133``). ``pix_idcs`` and ``noise`` are
    drawn from ``generator`` when not given, in that order. The VGG loss
    runs in f32, as the JAX package's NOVEL step does."""
    SB, H, W, _ = b["target_rgb"].shape
    with profiling.span("encode"):
        ctx = model.encode(*(b[k] for k in SRC_KEYS), train=True,
                           update_stats=update_stats)
        profiling.mark(ctx.latent, "encode")
        gen = gen_context_of(model, b, W, H)
    rays_sel, gt = select_rays(cfg, b, generator, pix_idcs)
    out = render_rays_novel(model.field, ctx, gen, rays_sel,
                            *(b[k] for k in NOVEL_KEYS), cfg.renderer,
                            noise=noise, generator=generator)
    with profiling.span("loss"):
        total, metrics = rgb_losses(cfg, out.rgb, gt, vgg)
        profiling.mark(total, "loss")
    return total, metrics


class NovelTrainStep(TrainStep):
    """One NOVEL optimizer step per call, as :class:`TrainStep`."""

    loss_fn = staticmethod(compute_novel_losses)


def create_novel_state(cfg: NovelConfig, seed: int = 0, device=None,
                       vgg=None) -> NovelTrainStep:
    """The model (seed ``seed``) and its Adam at ``cfg.lr``, as a train
    step; ``vgg`` is needed when ``w_vgg > 0``."""
    return NovelTrainStep(create_novel_model(cfg, seed, device), cfg, vgg)


def build_novel_run_config(run_cfg, use_pe: bool = False) -> NovelConfig:
    """A ``TrainRunConfig`` (``train/config.py``) → ``NovelConfig``: its
    PixelNeRF fields, renderer and optimizer settings, with the NOVEL_PE
    switch."""
    d = run_cfg.diner
    base = d.nerf
    nerf = NovelPixelNeRFConfig(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(base)}, use_pe_maps=use_pe)
    return NovelConfig(
        nerf=nerf, renderer=d.renderer, znear=d.znear, zfar=d.zfar,
        ray_batch_size=d.ray_batch_size, lr=d.lr, w_vgg=d.w_vgg,
        vgg_spatch=d.vgg_spatch, w_antibias=d.w_antibias,
        antibias_downsampling=d.antibias_downsampling)


def fit_novel(run_cfg, max_steps=None, use_pe: bool = False, device=None,
              num_workers: int = 2) -> NovelTrainStep:
    """Train NOVEL (or NOVEL_PE) on the config's train set until
    ``max_steps`` (forever when None), then checkpoint under
    ``run_dir/checkpoints`` (``train/checkpoint.py``) and return the train
    step. The VGG19 of the loss is the seed-0 draw and step ``n`` draws
    from a generator seeded with ``n + 1``."""
    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train.loop import arrays_of

    dev = resolve_device(device)
    cfg = build_novel_run_config(run_cfg, use_pe)
    loader = DataLoader(run_cfg.build_dataset("train"),
                        num_workers=num_workers,
                        **{"batch_size": 1, "shuffle": True,
                           **run_cfg.dataloader_kwargs("train")})
    vgg = init_vgg19(0, device=dev) if cfg.w_vgg > 0 else None
    state = create_novel_state(cfg, seed=0, device=dev, vgg=vgg)
    gen = torch.Generator(device=dev)
    while True:
        for batch in loader:
            if max_steps is not None and state.step >= max_steps:
                ckpt_lib.save_checkpoint(run_cfg.run_dir / "checkpoints",
                                         state, config_json=run_cfg.raw)
                return state
            gen.manual_seed(state.step + 1)
            metrics = state(arrays_of(batch), generator=gen)
            if state.step % 50 == 0:
                print(f"step {state.step} total "
                      f"{float(metrics['total']):.4f}", flush=True)
