"""TransMVSNet: coarse-to-fine multi-view-stereo depth (channels-first).

Port of ``diner_tpu/mvs/model.py`` (reference ``deps/TransMVSNet/models/
TransMVSNet.py`` + ``module.py``): an FPN with deformable-conv heads at 3
scales, the FMT pathway, and per stage a hypothesis range around the prior
depth, the plane-sweep similarity volume weighted by PixelwiseNet's view
visibilities, a 3-D U-Net, a softmax probability volume, winner-take-all
depth and the photometric confidence.

Submodules carry the reference's names (``feature.conv0.0``,
``FMT_with_pathway.FMT.layers.i``, ``cost_regularization.s.convN``,
``DepthNet.pixel_wise_net.convN``), so a reference checkpoint loads with
``load_state_dict`` after ``utils/convert.py:transmvsnet_reference_state_
dict``. Images enter channels-last, as the datasets give them; the model
runs channels-first and turns each source view's features to rows of C
for the plane sweep's gathers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch import nn

from diner_tpu_torch.mvs.blocks import (
    BatchNorm,
    Conv2d,
    Conv3d,
    ConvBnReLU,
    ConvBnReLU3D,
    DeconvBnReLU3D,
    remat,
    set_compute_dtype,
)
from diner_tpu_torch.mvs.dcn import DeformConv2d
from diner_tpu_torch.mvs.fmt import FMTWithPathway
from diner_tpu_torch.mvs.homography import homo_warping
from diner_tpu_torch.utils.resize import (
    resize_linear_2d,
    resize_nearest_2x,
    resize_trilinear,
)


@dataclass(frozen=True)
class TransMVSNetConfig:
    ndepths: Tuple[int, ...] = (48, 32, 8)
    depth_intervals_ratio: Tuple[float, ...] = (4.0, 2.0, 1.0)
    base_channels: int = 8
    cr_base_chs: Tuple[int, ...] = (8, 8, 8)
    grad_method: str = "detach"
    fmt_pe_type: str = "sine"  # or 'superglue' (FMT.py:125)
    # depth planes per plane-sweep step: one (B, chunk, H, W, C) warped
    # group is live at a time, which bounds peak memory
    sweep_chunk: int = 8
    # rematerialise in the backward (training): with ``remat``, each view's
    # plane sweep and each CostRegNet, and FeatureNet too with
    # ``remat_feature`` (False: "selective", FeatureNet's activations kept)
    remat: bool = False
    remat_feature: bool = True

    @property
    def num_stage(self) -> int:
        return len(self.ndepths)


def _dcn_head(bc: int, out: int, first_kernel: int):
    """Conv + [DCN, BN, ReLU] × 2 + DCN: the reference's ``outN``
    Sequential (DCNs at indices 1, 4, 7; BNs at 2, 5)."""
    return nn.Sequential(
        ConvBnReLU(4 * bc, 4 * bc, first_kernel),
        DeformConv2d(4 * bc, 4 * bc), BatchNorm(4 * bc), nn.ReLU(),
        DeformConv2d(4 * bc, 4 * bc), BatchNorm(4 * bc), nn.ReLU(),
        DeformConv2d(4 * bc, out))


class FeatureNet(nn.Module):
    """FPN with DCN heads. (N, 3, H, W) → stage1 (4bc, H/4), stage2
    (2bc, H/2), stage3 (bc, H)."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        bc = base_channels
        self.conv0 = nn.Sequential(ConvBnReLU(3, bc), ConvBnReLU(bc, bc))
        self.conv1 = nn.Sequential(
            ConvBnReLU(bc, 2 * bc, 5, stride=2, padding=2),
            ConvBnReLU(2 * bc, 2 * bc), ConvBnReLU(2 * bc, 2 * bc))
        self.conv2 = nn.Sequential(
            ConvBnReLU(2 * bc, 4 * bc, 5, stride=2, padding=2),
            ConvBnReLU(4 * bc, 4 * bc), ConvBnReLU(4 * bc, 4 * bc))
        self.out1 = _dcn_head(bc, 4 * bc, 1)
        self.inner1 = Conv2d(2 * bc, 4 * bc, 1)
        self.inner2 = Conv2d(bc, 4 * bc, 1)
        self.out2 = _dcn_head(bc, 2 * bc, 3)
        self.out3 = _dcn_head(bc, bc, 3)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        hw = (-2, -1)
        intra = resize_nearest_2x(conv2, hw) + self.inner1(conv1)
        stage2 = self.out2(intra)
        intra = resize_nearest_2x(intra, hw) + self.inner2(conv0)
        return {"stage1": self.out1(conv2), "stage2": stage2,
                "stage3": self.out3(intra)}


class PixelwiseNet(nn.Module):
    """Per-view visibility weight from the similarity volume:
    (B, D, H, W) → (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU3D(1, 16, 1, padding=0)
        self.conv1 = ConvBnReLU3D(16, 8, 1, padding=0)
        self.conv2 = Conv3d(8, 1, 1)

    def forward(self, x):
        x = self.conv2(self.conv1(self.conv0(x.unsqueeze(1))))
        return torch.sigmoid(x[:, 0]).amax(dim=1, keepdim=True)


class CostRegNet(nn.Module):
    """3-D U-Net cost regularisation. (B, D, H, W) → (B, D, H, W)."""

    def __init__(self, base_channels: int = 8):
        super().__init__()
        bc = base_channels
        self.conv0 = ConvBnReLU3D(1, bc)
        self.conv1 = ConvBnReLU3D(bc, 2 * bc, stride=2)
        self.conv2 = ConvBnReLU3D(2 * bc, 2 * bc)
        self.conv3 = ConvBnReLU3D(2 * bc, 4 * bc, stride=2)
        self.conv4 = ConvBnReLU3D(4 * bc, 4 * bc)
        self.conv5 = ConvBnReLU3D(4 * bc, 8 * bc, stride=2)
        self.conv6 = ConvBnReLU3D(8 * bc, 8 * bc)
        self.conv7 = DeconvBnReLU3D(8 * bc, 4 * bc)
        self.conv9 = DeconvBnReLU3D(4 * bc, 2 * bc)
        self.conv11 = DeconvBnReLU3D(2 * bc, bc)
        self.prob = Conv3d(bc, 1, 3, padding=1, bias=False)

    def forward(self, x):
        c0 = self.conv0(x.unsqueeze(1))
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        h = self.conv6(self.conv5(c4))
        h = c4 + self.conv7(h)
        h = c2 + self.conv9(h)
        h = c0 + self.conv11(h)
        return self.prob(h)[:, 0]


def get_depth_range_samples(cur_depth, ndepth: int, depth_interval_pixel,
                            shape):
    """Per-stage hypothesis depths (module.py:590-619).

    cur_depth: (B, D0) global range at stage 1 or (B, H, W) prior depth.
    Returns (B, ndepth, H, W).
    """
    B, H, W = shape
    idx = torch.arange(ndepth, dtype=torch.float32, device=cur_depth.device)
    if cur_depth.dim() == 2:
        dmin = cur_depth[:, 0]
        dmax = cur_depth[:, -1]
        interval = (dmax - dmin) / (ndepth - 1)
        samples = dmin[:, None] + idx[None] * interval[:, None]  # (B, D)
        return samples[:, :, None, None].expand(B, ndepth, H, W)
    dmin = cur_depth - ndepth / 2 * depth_interval_pixel  # (B, H, W)
    dmax = cur_depth + ndepth / 2 * depth_interval_pixel
    interval = (dmax - dmin) / (ndepth - 1)
    return dmin[:, None] + idx[:, None, None] * interval[:, None]


def depth_wta(prob_volume, depth_values):
    """Winner-take-all depth. prob (B, D, H, W); depths (B, D, H, W)."""
    idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    return torch.gather(depth_values, 1, idx)[:, 0]


def _full_proj(pm):
    """(B, 2, 4, 4) [extrinsics, intrinsics] → (B, 4, 4) K·[R|t]."""
    out = pm[:, 0].clone()
    out[:, :3, :4] = pm[:, 1, :3, :3] @ pm[:, 0, :3, :4]
    return out


class DepthNet(nn.Module):
    """One cascade stage: warped-similarity cost volume + regularisation."""

    def __init__(self, sweep_chunk: int = 8, remat: bool = False):
        super().__init__()
        self.sweep_chunk = sweep_chunk
        self.remat = remat
        self.pixel_wise_net = PixelwiseNet()

    def _similarity(self, src_fea, ref_fea, src_proj, ref_proj, dv):
        """Mean over channels of warped source × reference features,
        (B, D, H, W), swept ``sweep_chunk`` depth planes at a time."""
        D = dv.shape[1]
        chunk = D if D <= self.sweep_chunk else self.sweep_chunk
        if D % chunk:  # 48/32/8 (DTU) and 96/64/16 (FS) divide by 8/16
            chunk = 1
        return torch.cat([
            (homo_warping(src_fea, src_proj, ref_proj, dv[:, d:d + chunk])
             * ref_fea[:, None]).mean(dim=-1)
            for d in range(0, D, chunk)], dim=1)

    def forward(self, features: List, proj_matrices, depth_values,
                cost_regularization, view_weights=None):
        """
        features: per-view (B, C, H, W); proj_matrices: (B, V, 2, 4, 4)
        [extrinsics, intrinsics]; depth_values: (B, D, H, W).
        view_weights: (B, V-1, H, W) or None (stage 1 computes them).
        Returns (outputs dict, view_weights).
        """
        ref_fea = features[0].permute(0, 2, 3, 1)  # (B, H, W, C)
        ref_proj = _full_proj(proj_matrices[:, 0])
        similarity_sum = 0.0
        weight_sum = 1e-5
        new_weights = []
        sweep = (lambda *a: remat(self._similarity, *a)) if self.remat \
            else self._similarity
        for i, src in enumerate(features[1:]):
            similarity = sweep(
                src.permute(0, 2, 3, 1).contiguous(), ref_fea,
                _full_proj(proj_matrices[:, i + 1]), ref_proj, depth_values)
            if view_weights is None:
                w = self.pixel_wise_net(similarity)  # (B, 1, H, W)
                new_weights.append(w[:, 0])
            else:
                w = view_weights[:, i, None]
            similarity_sum = similarity_sum + similarity * w
            weight_sum = weight_sum + w
        similarity = similarity_sum / weight_sum

        cost = (remat(cost_regularization, similarity) if self.remat
                else cost_regularization(similarity))
        prob_volume = torch.softmax(cost, dim=1)
        out = {"depth": depth_wta(prob_volume, depth_values),
               "photometric_confidence": prob_volume.amax(dim=1),
               "prob_volume": prob_volume, "depth_values": depth_values}
        if view_weights is None:
            view_weights = torch.stack(new_weights, dim=1).detach()
        return out, view_weights


class TransMVSNet(nn.Module):
    """``dtype`` is the compute dtype of convolutions, DCNs, the FMT and
    the U-Nets (``diner_tpu/mvs/model.py:TransMVSNet.dtype``); parameters,
    BN statistics, pixel coordinates, homographies, DCN offsets and masks
    and the hypothesis depths stay f32."""

    def __init__(self, cfg: TransMVSNetConfig = TransMVSNetConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.feature = FeatureNet(cfg.base_channels)
        self.FMT_with_pathway = FMTWithPathway(cfg.base_channels,
                                               pe_type=cfg.fmt_pe_type)
        self.cost_regularization = nn.ModuleList(
            CostRegNet(cfg.cr_base_chs[i]) for i in range(cfg.num_stage))
        self.DepthNet = DepthNet(cfg.sweep_chunk, cfg.remat)
        set_compute_dtype(self, dtype)

    def forward(self, imgs, proj_matrices: Dict[str, torch.Tensor],
                depth_values) -> Dict:
        """
        imgs: (B, V, H, W, 3); proj_matrices: {"stageK": (B, V, 2, 4, 4)};
        depth_values: (B, D0) global depth range samples.
        """
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        depth_interval = ((depth_values[0, -1] - depth_values[0, 0])
                          / depth_values.shape[1])
        # one FeatureNet call over the B·V views (model.py:337-343)
        x = imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2)
        feats_all = (remat(self.feature, x)
                     if cfg.remat and cfg.remat_feature else self.feature(x))
        features = [{k: f.reshape((B, V) + f.shape[1:])[:, v]
                     for k, f in feats_all.items()} for v in range(V)]
        features = self.FMT_with_pathway(features)

        outputs: Dict = {}
        depth = None
        view_weights = None
        for stage_idx in range(cfg.num_stage):
            stage = f"stage{stage_idx + 1}"
            scale = 2 ** (cfg.num_stage - 1 - stage_idx)
            if depth is None:
                cur_depth = depth_values
            else:
                if cfg.grad_method == "detach":
                    depth = depth.detach()
                cur_depth = resize_linear_2d(depth, H, W, axes=(-2, -1))
            drs = get_depth_range_samples(
                cur_depth, cfg.ndepths[stage_idx],
                cfg.depth_intervals_ratio[stage_idx] * depth_interval,
                (B, H, W))
            dv = resize_trilinear(drs, cfg.ndepths[stage_idx], H // scale,
                                  W // scale, axes=(-3, -2, -1))
            if stage_idx > 0:
                view_weights = resize_nearest_2x(view_weights, (-2, -1))
            out_stage, view_weights = self.DepthNet(
                [f[stage] for f in features], proj_matrices[stage], dv,
                self.cost_regularization[stage_idx], view_weights)
            depth = out_stage["depth"]
            outputs[stage] = out_stage
        outputs.update(outputs[f"stage{cfg.num_stage}"])
        return outputs
