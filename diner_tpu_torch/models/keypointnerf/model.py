"""KeypointNeRF — the keypoint-conditioned generalizable face NeRF.

Port of ``diner_tpu/models/keypointnerf/model.py`` (reference
``src/models/keypointnerf.py``):

- geometry features from the stacked-hourglass encoder and texture
  features from the ResBlk encoder, on the source views average-pooled
  ``ds_geo`` / ``ds_tex`` times and scaled to [-1, 1] (:680-718);
- ``query``: project points into every source view, smooth boundary
  weights, view dropout in training, the rel_z_decay keypoint encoding,
  MLPUNetFusion → (sdf, radiance), and the IBR colour head (:728-886);
- ``render_rays``: stratified coarse samples, contribution-guided
  importance resampling, compositing with alpha = mask · relu(radiance)
  densities (``rgba2out``; :1165-1231), and ray–box clipping
  (``ray_bbox_intersection``, :1233-1290).

Every bilinear sample (the source masks, the two geometry levels, the
source images and the texture features) is ``ops/grid_sample.py``'s
``grid_sample_bilinear``, so each of its corner fetches is kernel C on the
card; the features' gradients flow through the row gathers' ``index_add_``.
``rgba2out`` is plain tensor code, as in the JAX package. A train-mode
render takes its random draws as a :class:`RenderNoise`, drawn from a
``torch.Generator`` by :func:`draw_render_noise` or given by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diner_tpu_torch.models.keypointnerf.modules import (
    HD_CH,
    Dense,
    HGFilterV2,
    IBRRenderingHead,
    MLPUNetFusion,
    ResBlkEncoder,
    pool_width,
    rel_z_decay_encoding,
)
from diner_tpu_torch.ops.grid_sample import grid_sample_bilinear

POOL_TYPES = ("mean", "var")


@dataclass(frozen=True)
class KeypointNeRFConfig:
    # spatial keypoint encoding (sp_args)
    sp_level: int = 3
    sp_scale: float = 1.0
    sp_sigma: float = 0.05
    n_kpt: int = 68
    # encoders
    ds_geo: int = 1
    ds_tex: int = 1
    geo_out_ch: int = 64
    geo_n_stack: int = 1
    geo_n_downsample: int = 4
    tex_ngf: int = 64
    tex_n_downsample: int = 3
    tex_n_blocks: int = 4
    tex_n_upsample: int = 2
    tex_out_ch: int = 8
    # fusion MLP
    mlp_dims1: Tuple[int, ...] = (0, 128, 128, 120, 64)  # [0] set from PE dim
    mlp_dims2: Tuple[int, ...] = (128, 64, 64, 2)
    skip_dims: Tuple[int, ...] = (64, 8)
    skip_layers: Tuple[int, ...] = (0, 2)
    # IBR head
    ibr_in_channels: int = 32
    gcompress_in: int = 128
    gcompress_out: int = 24
    # rendering
    train_out_h: int = 64
    train_out_w: int = 64
    dr_level: int = 5
    sample_per_ray_c: int = 64
    sample_per_ray_f: int = 64
    fine: bool = True
    rand_noise_std: float = 0.01
    nml_scale: float = 100.0
    znear: float = 1.0
    zfar: float = 2.5

    @property
    def sp_dim(self) -> int:
        return (1 + 2 * self.sp_level) * self.n_kpt

    @property
    def tex_ch(self) -> int:
        """The texture features' width."""
        if self.tex_n_upsample > 0:
            return self.tex_out_ch
        return self.tex_ngf * 2 ** self.tex_n_downsample


class RenderNoise(NamedTuple):
    """The draws of one train-mode :meth:`KeypointNeRF.render_rays` (the
    JAX package splits its key five ways, k1…k5):

    t (B, R, Sc) stratified uniforms (k1); noise_c (B, R·Sc, 1) and
    noise_f (B, R·(Sc+Sf), 1) the coarse and fine density noise (k2, k4);
    u_fine (B, R, Sf) the fine pass's inverse-CDF uniforms (k3); keep
    (B, V−1, 1, 1) and perm (B, V, 1, 1) the view dropout's keep and
    permutation uniforms (k5 and split(k5)[0]), shared by both passes.
    """

    t: torch.Tensor
    noise_c: torch.Tensor
    u_fine: torch.Tensor
    noise_f: torch.Tensor
    keep: torch.Tensor
    perm: torch.Tensor


def draw_render_noise(cfg: KeypointNeRFConfig, B: int, R: int, V: int,
                      generator=None, device=None) -> RenderNoise:
    """A :class:`RenderNoise` for B × R rays over V views from
    ``generator`` (on ``device``), drawn in the order of its fields."""
    Sc, Sf = cfg.sample_per_ray_c, cfg.sample_per_ray_f
    kw = dict(generator=generator, device=device)
    return RenderNoise(
        t=torch.rand((B, R, Sc), **kw),
        noise_c=torch.randn((B, R * Sc, 1), **kw),
        u_fine=torch.rand((B, R, Sf), **kw),
        noise_f=torch.randn((B, R * (Sc + Sf), 1), **kw),
        keep=torch.rand((B, V - 1, 1, 1), **kw),
        perm=torch.rand((B, V, 1, 1), **kw))


def linspace01(n: int, device=None):
    """``jnp.linspace(0, 1, n)`` bit for bit as XLA computes it:
    i · (1 / (n − 1)) in f32 (``torch.linspace`` steps from both ends and
    differs in the last bit)."""
    step = torch.tensor(1.0) / (n - 1)
    return torch.arange(n, dtype=torch.float32, device=device) * step.to(
        device)


def _avg_pool_nhwc(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _affine(M, x):
    """M[:, :3, :3] · x + M[:, :3, 3] for (BV, 4, 4) M and (BV, N, 3) x."""
    return (torch.einsum("bij,bnj->bni", M[:, :3, :3], x)
            + M[:, :3, 3][:, None])


class KeypointNeRF(nn.Module):
    def __init__(self, cfg: KeypointNeRFConfig = KeypointNeRFConfig()):
        super().__init__()
        self.cfg = cfg
        self.geo_encoder = HGFilterV2(cfg.geo_out_ch, cfg.geo_n_stack,
                                      cfg.geo_n_downsample)
        self.tex_encoder = ResBlkEncoder(
            cfg.tex_out_ch, cfg.tex_ngf, cfg.tex_n_downsample,
            cfg.tex_n_blocks, cfg.tex_n_upsample)
        dims1 = (cfg.sp_dim,) + tuple(cfg.mlp_dims1[1:])
        # the skip features are the geometry encoder's two levels, in order
        self.mlp_geo = MLPUNetFusion(
            dims1, cfg.mlp_dims2, (cfg.geo_out_ch, HD_CH), cfg.skip_layers,
            pool_types=POOL_TYPES)
        self.mlp_tex = IBRRenderingHead(
            cfg.ibr_in_channels, 3 + cfg.tex_ch + cfg.gcompress_out)
        self.ibr_compress_gfeat = Dense(pool_width(dims1[-1], POOL_TYPES),
                                        cfg.gcompress_out)

    # -------------------------------------------------------- encoders

    def encode_features(self, imgs):
        """imgs (BV, H, W, 3) in [0, 1] → (feat_geo list, feat_tex), each
        channels-last and contiguous (a flat row table per view)."""
        x = imgs
        for _ in range(self.cfg.ds_geo):
            x = _avg_pool_nhwc(x)
        feat_geo = [f.contiguous() for f in self.geo_encoder(2.0 * x - 1.0)]
        x = imgs
        for _ in range(self.cfg.ds_tex):
            x = _avg_pool_nhwc(x)
        feat_tex = self.tex_encoder(2.0 * x - 1.0).contiguous()
        return feat_geo, feat_tex

    # ----------------------------------------------------------- query

    def query(self, pts, view, cam: Dict, feat_geo, feat_tex, imgs, kpt3d,
              src_fg_mask, n_samples: int, train: bool, dropout=None):
        """Evaluate (sdf, radiance, rgb) at world points.

        pts: (B, N, 3); view: (B, N, 3) ray directions; cam: the source
        views' KRT (BV, 4, 4), extrin (BV, 4, 4), width and height; imgs
        (BV, H, W, 3); kpt3d (B, K, 3); src_fg_mask (BV, H, W, 1);
        dropout: the view-dropout uniforms (keep, perm) in training.
        Returns (out (B, N, 5) = [sdf, rad, rgb], valid (B, N, 1)).
        """
        cfg = self.cfg
        B, N, _ = pts.shape
        BV = cam["KRT"].shape[0]
        V = BV // B

        v = pts[:, None].expand(B, V, N, 3).reshape(BV, N, 3)
        vh = _affine(cam["KRT"], v)
        z = vh[..., 2:3]
        xy = vh[..., :2] / z
        width, height = cam["width"], cam["height"]
        xy = torch.stack([2.0 * xy[..., 0] / (width - 1.0) - 1.0,
                          2.0 * xy[..., 1] / (height - 1.0) - 1.0], dim=-1)
        zn = 2.0 * (z - cfg.znear) / (cfg.zfar - cfg.znear) - 1.0

        eps = 1e-2
        mask_xy = (xy >= -1.0 - eps) & (xy <= 1.0 + eps)
        mask_z = zn >= -1.0
        out_mask = (mask_xy[..., 0] | mask_xy[..., 1] | mask_z[..., 0]
                    )[..., None].float().reshape(B, V, N, 1)

        fg = grid_sample_bilinear(src_fg_mask, xy, "border",
                                  align_corners=True).reshape(B, V, N, 1)
        all_valid = torch.all(out_mask > 0, dim=1, keepdim=True)
        out_mask = (out_mask * torch.all(fg > 0.1, dim=1, keepdim=True)
                    * all_valid)

        if train and V > 1 and dropout is not None:
            # keep a random view always on, drop the others with p = 0.5
            u_keep, u_perm = dropout
            keep = torch.cat([torch.ones_like(u_perm[:, :1]),
                              (u_keep > 0.5).float()], dim=1)
            order = torch.argsort(u_perm, dim=1, stable=True)
            out_mask = out_mask * torch.take_along_dim(keep, order, dim=1)

        # smooth boundary weight
        xyz01 = 0.5 * torch.cat([xy, zn], dim=-1) + 0.5
        dist_b = torch.minimum(xyz01, 1.0 - xyz01)
        pw = torch.sigmoid(5.0 * (dist_b / 0.1 - 1.0))
        pw = pw[..., 0] * pw[..., 1] * pw[..., 2]
        pw = pw.reshape(B, V, N, 1) * out_mask
        pw = (pw / (torch.sum(pw, dim=1, keepdim=True) + 1e-6)).detach()

        feats = [grid_sample_bilinear(f, xy, "border", align_corners=True
                                      ).reshape(B, V, N, -1)
                 for f in feat_geo]

        # rel_z_decay keypoint encoding in each camera frame
        Rt = cam["extrin"]
        kpt = kpt3d[:, None].expand((B, V) + tuple(kpt3d.shape[1:])
                                    ).reshape(BV, -1, 3)
        y = rel_z_decay_encoding(_affine(Rt, v), _affine(Rt, kpt),
                                 cfg.sp_level, cfg.sp_scale, cfg.sp_sigma)
        y = y.reshape(B, V, N, -1)

        out, valid, _, latent_fused = self.mlp_geo(y, feats, out_mask, pw)

        rgb = self._query_color(v, xy, view, V, feat_tex, latent_fused, cam,
                                imgs, out_mask.reshape(BV, N, 1), n_samples)
        return torch.cat([out, rgb], dim=-1), valid

    def _query_color(self, v, xy, view, V, feat_tex, latent_fused, cam,
                     imgs, out_mask, n_samples: int):
        """IBR colour head (keypointnerf.py:827-886)."""
        BV, N, _ = v.shape
        B = BV // V
        img_xy = grid_sample_bilinear(imgs, xy, "border", align_corners=True)
        feat_xy = grid_sample_bilinear(feat_tex, xy, "border",
                                       align_corners=True)
        latent = self.ibr_compress_gfeat(latent_fused)  # (B, N, gc)
        latent = latent[:, None].expand((B, V) + tuple(latent.shape[1:])
                                        ).reshape(BV, N, -1)
        rgb_feat = torch.cat([img_xy, feat_xy, latent], dim=-1)

        # inv_ex: no host sync for an error check on the card
        inv_krt = torch.linalg.inv_ex(cam["KRT"])[0]
        cam_pos = inv_krt[:, :3, 3]
        cam_rays = v - cam_pos[:, None]
        cam_rays = cam_rays / torch.linalg.norm(cam_rays, dim=-1,
                                                keepdim=True)
        view_bv = view[:, None].expand(B, V, N, 3).reshape(BV, N, 3)
        ray_diff = (view_bv - cam_rays).reshape(B, V, N, 3)
        rd_norm = torch.linalg.norm(ray_diff, dim=-1, keepdim=True)
        rd_dot = torch.sum(cam_rays * view_bv, dim=-1).reshape(B, V, N, 1)
        ray_diff = torch.cat([ray_diff / torch.clamp(rd_norm, min=1e-6),
                              rd_dot], dim=-1)

        pHW = N // n_samples

        def to_rays(t):
            t = t.reshape(B, V, pHW, n_samples, -1)
            return t.permute(0, 2, 3, 1, 4).reshape(
                B * pHW, n_samples, V, -1)

        rgb = self.mlp_tex(to_rays(rgb_feat.reshape(B, V, N, -1)),
                           to_rays(ray_diff),
                           to_rays(out_mask.reshape(B, V, N, 1)))
        return rgb.reshape(B, N, 3)

    # ------------------------------------------------------- rendering

    def render_rays(self, ray_o, ray_d, znear_r, zfar_r, cam_in, feat_geo,
                    feat_tex, imgs, kpt3d, src_fg_mask, train: bool,
                    noise: Optional[RenderNoise] = None):
        """Coarse (+ fine) volume rendering of given rays.

        ray_o (B, R, 3), ray_d (B, R, 3) unit, znear_r / zfar_r (B, R, 1);
        ``noise`` holds the draws of a train-mode render (eval draws
        nothing: no noise, no dropout, midpoint-rule resampling).
        Returns a dict with color / depth / alpha (+ _fine, sdf).
        """
        cfg = self.cfg
        B, R, _ = ray_o.shape
        Sc = cfg.sample_per_ray_c
        if train and noise is None:
            raise ValueError("a train-mode render needs its RenderNoise")

        t = linspace01(Sc, ray_o.device).expand(B, R, Sc)
        if train:
            mid = 0.5 * (t[..., 1:] + t[..., :-1])
            lower = torch.cat([t[..., :1], mid], dim=-1)
            upper = torch.cat([mid, t[..., -1:]], dim=-1)
            t = lower + noise.t * (upper - lower)
        z = znear_r + (zfar_r - znear_r) * t  # (B, R, Sc)
        dropout = (noise.keep, noise.perm) if train else None

        def eval_at(zv, rad_noise):
            S = zv.shape[-1]
            pts = ray_o[:, :, None] + ray_d[:, :, None] * zv[..., None]
            pts = pts.reshape(B, -1, 3)
            view = ray_d[:, :, None].expand(B, R, S, 3).reshape(B, -1, 3)
            rgba, mask = self.query(pts, view, cam_in, feat_geo, feat_tex,
                                    imgs, kpt3d, src_fg_mask, S, train,
                                    dropout=dropout)
            maskf = mask.float()
            sdf = maskf * rgba[..., :1] + (1 - maskf) * (0.1 / cfg.nml_scale)
            rad = rgba[..., 1:2]
            rgb = rgba[..., 2:]
            if train and cfg.rand_noise_std > 0:
                rad = rad + rad_noise * cfg.rand_noise_std
            alpha = maskf * torch.relu(rad)
            out = torch.cat([alpha, sdf, rgb], dim=-1)
            return out.reshape(B, R, S, -1)

        rgba_c = eval_at(z, noise.noise_c if train else None)
        color, depth, alpha, contrib, sdf = rgba2out(rgba_c, z)
        out = {"color": color, "depth": depth, "alpha": alpha}

        if cfg.fine:
            z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
            z_fine = importance_sample(contrib[..., 1:-1], z_mid,
                                       cfg.sample_per_ray_f,
                                       u=noise.u_fine if train else None)
            z_all = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)[0]
            rgba_f = eval_at(z_all, noise.noise_f if train else None)
            color_f, depth_f, alpha_f, _, sdf_f = rgba2out(rgba_f, z_all)
            out.update({"color_fine": color_f, "depth_fine": depth_f,
                        "alpha_fine": alpha_f, "sdf": sdf_f})
        return out


def rgba2out(rgba, z):
    """Composite [alpha-density, sdf, rgb] samples (keypointnerf.py:
    1205-1231). rgba (B, R, S, 5), z (B, R, S) sorted. Returns (color,
    depth, alpha, contrib, sdf)."""
    alpha = rgba[..., 0]
    sdf = rgba[..., 1]
    rgb = rgba[..., 2:]
    dist = torch.cat([z[..., 1:] - z[..., :-1],
                      1e10 * torch.ones_like(z[..., :1])], dim=-1)
    contrib = 1.0 - torch.exp(-alpha * dist)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(contrib[..., :1]), 1 - contrib[..., :-1]], dim=-1),
        dim=-1)
    contrib = contrib * trans
    color = torch.sum(rgb * contrib[..., None], dim=-2)
    acc = torch.sum(contrib, dim=-1)
    sdf_out = torch.sum(sdf * contrib, dim=-1) / (acc + 1e-8)
    depth = torch.sum(z * contrib, dim=-1) / (acc + 1e-8)
    return color, depth, acc, contrib, sdf_out


def importance_sample(contrib, z, n: int, u=None):
    """Inverse-CDF resampling of ray contributions (keypointnerf.py:
    1165-1203). contrib (B, R, D−2), z (B, R, D−1); ``u`` (B, R, n)
    uniforms, or None for the midpoint rule (``linspace(0, 1, n)``)."""
    contrib = contrib.detach() + 1e-5
    pdf = contrib / torch.sum(contrib, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    if u is None:
        sample = linspace01(n, cdf.device).expand(cdf.shape[:-1] + (n,))
    else:
        sample = u

    idx = _batched_searchsorted(cdf, sample)
    idx_prev = torch.clamp(idx - 1, min=0)
    idx = torch.clamp(idx, max=cdf.shape[-1] - 1)

    cdf_prev = torch.gather(cdf, -1, idx_prev)
    cdf_next = torch.gather(cdf, -1, idx)
    zmax = z.shape[-1] - 1
    z_prev = torch.gather(z, -1, torch.clamp(idx_prev, 0, zmax))
    z_next = torch.gather(z, -1, torch.clamp(idx, 0, zmax))
    den = cdf_next - cdf_prev
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return z_prev + (sample - cdf_prev) / den * (z_next - z_prev)


def _batched_searchsorted(cdf, sample):
    """searchsorted(right) along the last axis for batched inputs."""
    return torch.sum(sample[..., None] >= cdf[..., None, :], dim=-1)


def ray_bbox_intersection(bounds, orig, direct, boffset=(-0.01, 0.01)):
    """Ray–AABB clipping (keypointnerf.py:1233-1290), masked math.

    bounds (B, 2, 3); orig (B, 1, 3); direct (B, R, 3).
    Returns (near (B, R, 1), far (B, R, 1), hit (B, R, 1)); near/far are 1.0
    where the ray misses (the reference's fill value).
    """
    b = bounds + torch.tensor(boffset, dtype=bounds.dtype,
                              device=bounds.device)[None, :, None]
    d = torch.where(torch.abs(direct) < 1e-5, 1e-5, direct)
    tt = (b[:, None] - orig[:, :, None]) / d[:, :, None]  # (B, R, 2, 3)
    B, R = d.shape[:2]
    t6 = tt.reshape(B, R, 6)
    p = t6[..., None] * d[:, :, None] + orig  # (B, R, 6, 3)
    lo = b[:, 0][:, None, None]
    hi = b[:, 1][:, None, None]
    eps = 1e-6
    inside = torch.all((p >= lo - eps) & (p <= hi + eps), dim=-1)
    hit = torch.sum(inside, dim=-1) == 2
    tabs = torch.abs(t6)
    near = torch.amin(torch.where(inside, tabs, torch.inf), dim=-1)
    far = torch.amax(torch.where(inside, tabs, -torch.inf), dim=-1)
    near = torch.where(hit, near, 1.0)[..., None]
    far = torch.where(hit, far, 1.0)[..., None]
    return near, far, hit[..., None]
