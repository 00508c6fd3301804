"""KeypointNeRF training and full-image rendering.

Port of ``diner_tpu/models/keypointnerf/train.py`` (reference
``src/models/keypointnerf.py``'s LightningModule): the camera packing of
``decode_batch`` (:278-363), the mask-centred 64×64 training patch
(:1062-1072), target rays through inv(K) and RT clipped to the face box
(:1080-1100), the losses of ``compute_error`` (L1 coarse and fine, VGG on
the fine patch), one Adam step, and strided-tile full-image rendering
recombined by pixel shuffle (:952-996) with the encoders run once per
image and 16 tiles per call.

Random draws come from an explicit ``torch.Generator``: the patch centre
first, then the render's :class:`RenderNoise`. A caller may pass both
(``center=``, ``noise=``), as the JAX package's ``k_patch`` / ``k_render``
split of one key gives them. As there, the weights are a plain seeded draw
and the VGG19 of the loss is the seed-0 draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional

import numpy as np
import torch

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.losses import l1_loss, vgg_loss
from diner_tpu_torch.models.keypointnerf.model import (
    KeypointNeRF,
    KeypointNeRFConfig,
    RenderNoise,
    draw_render_noise,
    ray_bbox_intersection,
)
from diner_tpu_torch.models.keypointnerf.modules import reset_all
from diner_tpu_torch.train.diner import batch_to_device

# the batch entries a step and a render read (the sphere's and FaceScape's
# KeypointNeRF schema hold them all)
BATCH_KEYS = ("src_rgbs", "src_alphas", "src_extrinsics", "src_intrinsics",
              "target_rgb", "target_mask", "target_extrinsics",
              "target_intrinsics", "target_kpt3d", "bounds")


@dataclass(frozen=True)
class KeypointNeRFTrainConfig:
    model: KeypointNeRFConfig = dc_field(default_factory=KeypointNeRFConfig)
    lr: float = 1e-4
    lambda_l1_c: float = 1.0
    lambda_l1: float = 10.0
    lambda_vgg: float = 0.5


def decode_cameras(batch) -> Dict:
    """Pack per-view camera dicts (decode_batch, keypointnerf.py:278-341)
    from the channels-last FaceScape keys (src_* / target_*)."""
    src_extr = batch["src_extrinsics"]  # (B, V, 4, 4)
    src_intr = batch["src_intrinsics"]  # (B, V, 3, 3)
    B, V = src_extr.shape[:2]
    H, W = batch["src_rgbs"].shape[2:4]
    dev = src_extr.device

    K4 = torch.eye(4, device=dev).repeat(B * V, 1, 1)
    K4[:, :3, :3] = src_intr.reshape(B * V, 3, 3)
    extrin = src_extr.reshape(B * V, 4, 4)
    cam = {"KRT": torch.einsum("bij,bjk->bik", K4, extrin), "K": K4,
           "extrin": extrin, "width": W, "height": H}
    tK4 = torch.eye(4, device=dev).repeat(B, 1, 1)
    tK4[:, :3, :3] = batch["target_intrinsics"]
    cam_tar = {"K": tK4, "RT": batch["target_extrinsics"], "width": W,
               "height": H}
    return {"cam": cam, "cam_tar": cam_tar}


def target_rays(cam_tar, grids, znear: float, zfar: float, bounds):
    """World rays through target pixels with box-clipped near / far
    (keypointnerf.py:1080-1100). grids: (B, R, 2) pixel coordinates.
    Returns (orig (B, 1, 3), dirs (B, R, 3), znear (B, R, 1), zfar)."""
    ones = torch.ones_like(grids[..., :1])
    grids_h = torch.cat([grids, ones], dim=-1)
    inv_K = torch.linalg.inv_ex(cam_tar["K"][:, :3, :3])[0].transpose(-1, -2)
    cam_rays = torch.einsum("brj,bjk->brk", grids_h, inv_K)
    znear_r = torch.linalg.norm(znear * cam_rays, dim=-1, keepdim=True)
    zfar_r = torch.linalg.norm(zfar * cam_rays, dim=-1, keepdim=True)
    RT = cam_tar["RT"]
    dirs = torch.einsum("brj,bjk->brk", cam_rays, RT[:, :3, :3])
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    orig = -torch.einsum("bj,bjk->bk", RT[:, :3, 3], RT[:, :3, :3])[:, None]

    z1, z2, hit = ray_bbox_intersection(bounds, orig, dirs)
    m1 = (hit & (z1 > znear_r)).float()
    znear_r = m1 * z1 + (1 - m1) * znear_r
    m2 = (hit & (z2 < zfar_r)).float()
    zfar_r = m2 * z2 + (1 - m2) * zfar_r
    return orig, dirs, znear_r, zfar_r


def patch_center(mask, generator=None):
    """(B,) flat index of a uniformly drawn pixel where ``mask`` (B, H, W)
    is positive: the JAX package's Gumbel-max draw over the mask."""
    B = mask.shape[0]
    return torch.multinomial((mask.reshape(B, -1) > 0).float(), 1,
                             generator=generator)[:, 0]


def training_patch_grid(mask, out_h: int, out_w: int, center):
    """The mask-centred training patch (keypointnerf.py:1062-1072) around
    the flat pixel index ``center`` (B,) → (B, out_h·out_w, 2) f32 pixel
    coordinates, clipped to [0, min(W, H) − 1] as the reference does."""
    B, H, W = mask.shape
    cx = (center % W)[:, None]
    cy = torch.div(center, W, rounding_mode="floor")[:, None]
    dev = mask.device
    gy, gx = torch.meshgrid(torch.arange(out_h, device=dev),
                            torch.arange(out_w, device=dev), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(-1, 2)[None]
    grid = grid + torch.stack([cx, cy], dim=-1) - out_h // 2
    grid = torch.clamp(grid, 0, min(W - 1, H - 1))
    return grid.float()


def create_keypointnerf_model(cfg: KeypointNeRFConfig, seed: int = 0,
                              device=None) -> KeypointNeRF:
    """A KeypointNeRF with every weight drawn from ``torch.Generator(seed)``
    with flax's initializers, on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    model = KeypointNeRF(cfg)
    reset_all(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def compute_losses(model: KeypointNeRF, cfg: KeypointNeRFTrainConfig, b,
                   vgg=None, generator=None,
                   noise: Optional[RenderNoise] = None, center=None):
    """Patch render + L1 (coarse) + L1 / VGG (fine) on the tensors ``b``
    (``compute_error_nerf``) → (total, losses). ``center`` and ``noise``
    are drawn from ``generator`` when not given, in that order."""
    mcfg = cfg.model
    B, V, H, W, _ = b["src_rgbs"].shape
    imgs = b["src_rgbs"].reshape(B * V, H, W, 3)
    cams = decode_cameras(b)
    if center is None:
        center = patch_center(b["target_mask"], generator)
    grids = training_patch_grid(b["target_mask"], mcfg.train_out_h,
                                mcfg.train_out_w, center)
    orig, dirs, zn, zf = target_rays(cams["cam_tar"], grids, mcfg.znear,
                                     mcfg.zfar, b["bounds"])
    if noise is None:
        noise = draw_render_noise(mcfg, B, grids.shape[1], V, generator,
                                  imgs.device)

    feat_geo, feat_tex = model.encode_features(imgs)
    out = model.render_rays(
        orig.expand_as(dirs), dirs, zn, zf, cams["cam"], feat_geo, feat_tex,
        imgs, b["target_kpt3d"], b["src_alphas"].reshape(B * V, H, W, 1),
        train=True, noise=noise)

    # the target pixels at the patch grid
    idx = (grids[..., 0] + grids[..., 1] * W).long()
    tar = torch.gather(b["target_rgb"].reshape(B, H * W, 3), 1,
                       idx[..., None].expand(-1, -1, 3))

    s = mcfg.train_out_h
    losses = {}
    total = cfg.lambda_l1_c * l1_loss(out["color"], tar)
    losses["e_pix_c"] = total
    if "color_fine" in out:
        lf = cfg.lambda_l1 * l1_loss(out["color_fine"], tar)
        losses["e_pix_l1"] = lf
        total = total + lf
        if vgg is not None and cfg.lambda_vgg > 0:
            lv = cfg.lambda_vgg * vgg_loss(
                vgg, out["color_fine"].reshape(B, s, s, 3),
                tar.reshape(B, s, s, 3))
            losses["e_vgg"] = lv
            total = total + lv
    losses["e_all"] = total
    return total, losses


class KeypointNeRFTrainStep:
    """One Adam step per call: ``(batch, generator=None, noise=None,
    center=None) → losses`` (0-d tensors on the model's device).

    ``optimizer`` is an Adam over every parameter (torch's ε and bias
    correction are optax's); ``step`` counts the steps taken. After a call
    each parameter's ``.grad`` holds the step's gradient.
    """

    def __init__(self, model: KeypointNeRF, cfg: KeypointNeRFTrainConfig,
                 vgg=None):
        if cfg.lambda_vgg > 0 and vgg is None:
            raise ValueError("lambda_vgg > 0 needs a VGG19Features "
                             "(init_vgg19)")
        self.model, self.cfg, self.vgg = model, cfg, vgg
        self.optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
        self.step = 0

    def __call__(self, batch, generator=None, noise=None, center=None):
        dev = next(self.model.parameters()).device
        b = batch_to_device(batch, dev)
        if noise is not None:
            noise = RenderNoise(*(torch.as_tensor(t).to(dev) for t in noise))
        if center is not None:
            center = torch.as_tensor(center).to(dev)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = compute_losses(self.model, self.cfg, b, self.vgg,
                                       generator, noise, center)
        total.backward()
        for p in self.model.parameters():
            if p.grad is None:  # optax steps every parameter, zero or not
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}


def create_keypointnerf_state(cfg: KeypointNeRFTrainConfig, seed: int = 0,
                              device=None, vgg=None) -> KeypointNeRFTrainStep:
    """The model (seed ``seed``) and its Adam at ``cfg.lr``, as a train
    step; ``vgg`` is needed when ``lambda_vgg > 0``."""
    return KeypointNeRFTrainStep(
        create_keypointnerf_model(cfg.model, seed, device), cfg, vgg)


@torch.no_grad()
def render_full_image(model: KeypointNeRF, cfg: KeypointNeRFConfig, batch,
                      level: Optional[int] = None, tiles_per_call: int = 16):
    """Strided-tile rendering recombined by pixel shuffle (render_pifu_nerf,
    keypointnerf.py:952-996) on the model's device → numpy (color (H, W, 3)
    clipped to [0, 1], depth (H, W)).

    The encoders run once per image (they read only the source views) and
    ``tiles_per_call`` strided tiles (the largest divisor of the tile count
    up to it) go through one ``render_rays`` call. Rays are independent and
    an eval render draws nothing, so the grouping changes no value.
    """
    level = level if level is not None else cfg.dr_level
    stride = 2 ** (level - 1)
    dev = next(model.parameters()).device
    b = batch_to_device(batch, dev)
    B, V, H, W, _ = b["src_rgbs"].shape
    if B != 1:
        raise ValueError("full-image rendering is per sample (B = 1)")
    imgs = b["src_rgbs"].reshape(B * V, H, W, 3)
    masks = b["src_alphas"].reshape(B * V, H, W, 1)
    cams = decode_cameras(b)
    feat_geo, feat_tex = model.encode_features(imgs)

    out_h, out_w = H // stride, W // stride
    gy, gx = torch.meshgrid(torch.arange(0, H, stride, device=dev),
                            torch.arange(0, W, stride, device=dev),
                            indexing="ij")
    base = torch.stack([gx, gy], dim=-1).reshape(1, -1, 2).float()

    offsets = [(i, j) for i in range(stride) for j in range(stride)]
    group = max(1, min(tiles_per_call, len(offsets)))
    while len(offsets) % group:  # one grid shape for every call
        group -= 1

    color = np.zeros((H, W, 3), np.float32)
    depth = np.zeros((H, W), np.float32)
    for g0 in range(0, len(offsets), group):
        chunk = offsets[g0:g0 + group]
        grids = torch.cat([base + torch.tensor([[j, i]], dtype=torch.float32,
                                               device=dev)
                           for i, j in chunk], dim=1)
        orig, dirs, zn, zf = target_rays(cams["cam_tar"], grids, cfg.znear,
                                         cfg.zfar, b["bounds"])
        out = model.render_rays(orig.expand_as(dirs), dirs, zn, zf,
                                cams["cam"], feat_geo, feat_tex, imgs,
                                b["target_kpt3d"], masks, train=False)
        c = out.get("color_fine", out["color"]).reshape(
            len(chunk), out_h, out_w, 3).cpu().numpy()
        d = out.get("depth_fine", out["depth"]).reshape(
            len(chunk), out_h, out_w).cpu().numpy()
        for t, (i, j) in enumerate(chunk):
            color[i::stride, j::stride] = c[t]
            depth[i::stride, j::stride] = d[t]
    return np.clip(color, 0, 1), depth


def build_keypointnerf_run_config(run_cfg) -> KeypointNeRFTrainConfig:
    """A ``TrainRunConfig`` (``train/config.py``) → KeypointNeRFTrainConfig:
    znear / zfar from the run config, the model's kwargs and the lambdas
    from ``keypoint_nerf``, the learning rate from
    ``optimizer_keypointnerf`` (``train.py:280-295``)."""
    raw = run_cfg.raw
    kn = raw.get("keypoint_nerf", {})
    lambdas = kn.get("lambdas", {})
    return KeypointNeRFTrainConfig(
        model=KeypointNeRFConfig(
            znear=run_cfg.diner.znear, zfar=run_cfg.diner.zfar,
            **kn.get("kwargs", {})),
        lr=float(raw.get("optimizer_keypointnerf", {})
                 .get("kwargs", {}).get("lr", 1e-4)),
        lambda_l1_c=lambdas.get("lambda_l1_c", 1.0),
        lambda_l1=lambdas.get("lambda_l1", 10.0),
        lambda_vgg=lambdas.get("lambda_vgg", 0.5),
    )


def fit_keypointnerf(run_cfg, max_steps=None, device=None,
                     num_workers: int = 2) -> KeypointNeRFTrainStep:
    """Train KeypointNeRF on the config's train set until ``max_steps``
    (forever when None), then checkpoint under ``run_dir/checkpoints``
    (``train/checkpoint.py``) and return the train step. Step ``n`` draws
    from a generator seeded with ``n + 1``."""
    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train.loop import arrays_of

    dev = resolve_device(device)
    cfg = build_keypointnerf_run_config(run_cfg)
    loader = DataLoader(run_cfg.build_dataset("train"),
                        num_workers=num_workers,
                        **{"batch_size": 1, "shuffle": True,
                           **run_cfg.dataloader_kwargs("train")})
    vgg = init_vgg19(0, device=dev) if cfg.lambda_vgg > 0 else None
    state = create_keypointnerf_state(cfg, seed=0, device=dev, vgg=vgg)
    gen = torch.Generator(device=dev)
    while True:
        for batch in loader:
            if max_steps is not None and state.step >= max_steps:
                ckpt_lib.save_checkpoint(run_cfg.run_dir / "checkpoints",
                                         state, config_json=run_cfg.raw)
                return state
            gen.manual_seed(state.step + 1)
            losses = state(arrays_of(batch), generator=gen)
            if state.step % 50 == 0:
                print(f"step {state.step} e_all "
                      f"{float(losses['e_all']):.4f}", flush=True)


def get_360_cameras(headpose: np.ndarray, focal: float, trans: float,
                    sc_factor: float, im_w: int, im_h: int,
                    n_frames: int = 90):
    """360-degree orbit cameras around a head pose (keypointnerf_util.py:
    23-73). Returns a list of dicts with w2cs / c2ws / intrinsics per
    frame."""
    from scipy.spatial.transform import Rotation

    T_i = np.eye(4, dtype=np.float32)
    T_i[:3, :3] = headpose[:3, :3].T
    T_i[:3, 3] = -headpose[:3, :3].T @ headpose[:3, 3]

    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = np.array([[focal, 0, im_w / 2], [0, focal, im_h / 2],
                           [0, 0, 1]], np.float32)
    dR1 = Rotation.from_rotvec([np.pi, 0, 0]).as_matrix()

    cams = []
    for idx in range(n_frames):
        theta = 2.0 * np.pi * idx / n_frames
        dR2 = Rotation.from_rotvec([0, theta, 0]).as_matrix()
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = (dR1 @ dR2).astype(np.float32)
        E[:3, 3] = [0, 0, trans]
        extr = (E @ T_i).astype(np.float32)
        extr[:3, 3] *= sc_factor
        cams.append({
            "w2cs": extr,
            "c2ws": np.linalg.inv(extr).astype(np.float32),
            "intrinsics": K4,
            "im_w": im_w, "im_h": im_h,
        })
    return cams
