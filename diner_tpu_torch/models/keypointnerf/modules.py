"""KeypointNeRF building blocks.

Port of ``diner_tpu/models/keypointnerf/modules.py`` (reference
``src/util/keypointnerf_util.py`` and ``src/models/keypointnerf.py``):

- the weight-normed MLPs: ``WNLinear``, ``MLP``, ``MLPUNet``,
  ``pool_ops``, ``MLPUNetFusion``;
- the stacked-hourglass geometry encoder ``HGFilterV2`` (flax's GroupNorm,
  a bicubic skip upsample);
- the ResBlk texture encoder ``ResBlkEncoder`` (instance norm, edge pads);
- the IBRNet-style colour head ``IBRRenderingHead``;
- the keypoint encodings ``keypoint_position_embedding`` and
  ``rel_z_decay_encoding``.

The convolutional encoders take and return channels-last (N, H, W, C)
tensors, as the JAX package's, and run NCHW inside. Parameter names follow
the flax tree (``utils/convert.py:keypointnerf_flax_to_state_dict``):
convolutions ``weight`` (O, I, kH, kW) and ``bias``, GroupNorm ``weight``
(flax's ``scale``) and ``bias``, dense layers ``weight`` (out, in),
WNLinear ``v`` (in, out), ``g`` (out,) and ``bias`` as flax keeps them.
Every module's ``reset_parameters(generator)`` draws flax's initializers:
lecun-normal kernels, zero biases, unit GroupNorm scales, g = ‖v‖.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diner_tpu_torch.models.novel.model import LecunDense as Dense
from diner_tpu_torch.nn.resnet import lecun_normal_
from diner_tpu_torch.utils.resize import resize_bicubic_align_corners

# the geometry encoder's high-resolution output width (HGFilterV2.out_ch_hd)
HD_CH = 8


def get_nl(name: Optional[str]):
    if name in (None, "none", "None", ""):
        return None
    return {
        "leakyrelu": lambda x: F.leaky_relu(x, 0.2),
        "softplus": lambda x: F.softplus(100.0 * x) / 100.0,
        "elu": F.elu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "relu": torch.relu,
    }[name]


def reset_all(module: nn.Module, generator):
    """Draw the parameters of ``module`` and of every submodule from
    ``generator`` with flax's initializers."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class WNLinear(nn.Module):
    """Linear with weight normalization (torch ``weight_norm`` dim=0 in the
    reference): w = v / ‖v‖₀ · g, as flax's ``WNLinear``; without it a
    plain dense layer named ``linear``."""

    def __init__(self, d_in: int, d_out: int, weight_norm: bool = True):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(d_in, d_out))
            self.g = nn.Parameter(torch.empty(d_out))
            self.bias = nn.Parameter(torch.zeros(d_out))
        else:
            self.linear = Dense(d_in, d_out)

    def reset_parameters(self, generator):
        if not self.weight_norm:
            return
        with torch.no_grad():
            w = torch.empty(self.v.shape[1], self.v.shape[0])
            lecun_normal_(w, generator)
            self.v.copy_(w.T)
            self.g.copy_(torch.linalg.norm(self.v, dim=0))
            self.bias.zero_()

    def forward(self, x):
        if not self.weight_norm:
            return self.linear(x)
        w = self.v / torch.linalg.norm(self.v, dim=0, keepdim=True) * self.g
        return x @ w + self.bias


class MLP(nn.Module):
    """Skip-connected MLP (keypointnerf_util.py:590-622); the input width
    is ``n_dims[0]`` (``+ n_dims[0]`` again at a skip layer)."""

    def __init__(self, n_dims: Sequence[int], skip_layers: Sequence[int] = (),
                 nl_layer: str = "softplus", weight_norm: bool = True,
                 last_op: Optional[str] = None):
        super().__init__()
        self.n = len(n_dims) - 1
        self.skip_layers = tuple(skip_layers)
        self.nl, self.last = get_nl(nl_layer), get_nl(last_op)
        for i in range(self.n):
            d_in = n_dims[i] + (n_dims[0] if i in self.skip_layers else 0)
            self.add_module(f"layer_{i}", WNLinear(
                d_in, n_dims[i + 1], weight_norm and i != self.n - 1))

    def forward(self, x):
        x0 = x
        for i in range(self.n):
            if i in self.skip_layers:
                x = torch.cat([x, x0], dim=-1)
            x = getattr(self, f"layer_{i}")(x)
            if i != self.n - 1 and self.nl is not None:
                x = self.nl(x)
        return self.last(x) if self.last is not None else x


class MLPUNet(nn.Module):
    """MLP with image-feature skip injections (keypointnerf_util.py:684-755).

    ``skip_dims`` are the widths of the features concatenated at
    ``skip_layers``: the first layer takes ``n_dims[0]`` plus the first of
    them where layer 0 is a skip layer.
    """

    def __init__(self, n_dims: Sequence[int], skip_dims: Sequence[int],
                 skip_layers: Sequence[int], nl_layer: str = "softplus",
                 weight_norm: bool = True, addition: bool = False):
        super().__init__()
        self.n = len(n_dims) - 1
        self.skip = {j: i for i, j in enumerate(skip_layers)}
        self.addition = addition
        self.nl = get_nl(nl_layer)
        for i in range(self.n):
            d_in = n_dims[i]
            if i in self.skip and not addition:
                d_in += skip_dims[self.skip[i]]
            self.add_module(f"layer_{i}", WNLinear(
                d_in, n_dims[i + 1], weight_norm and i != self.n - 1))

    def forward(self, x, feats: List[torch.Tensor]):
        for i in range(self.n):
            if i in self.skip:
                f = feats[self.skip[i]]
                if x is None:
                    x = f
                else:
                    x = x + f if self.addition else torch.cat([x, f], dim=-1)
            x = getattr(self, f"layer_{i}")(x)
            if i != self.n - 1 and self.nl is not None:
                x = self.nl(x)
        return x


def pool_ops(x, pool_types: Sequence[str], w=None):
    """View pooling (keypointnerf_util.py:757-783). x: (B, V, N, C)."""
    ret = []
    if "max" in pool_types:
        ret.append(torch.amax(x, dim=1))
    if any(p in pool_types for p in ("mean", "var")):
        mean = torch.sum(w * x, dim=1) if w is not None else x.mean(dim=1)
        if "mean" in pool_types:
            ret.append(mean)
        if "var" in pool_types:
            d2 = (x - mean[:, None]) ** 2
            ret.append(torch.sum(w * d2, dim=1) if w is not None
                       else d2.mean(dim=1))
    return torch.cat(ret, dim=-1)


def pool_width(width: int, pool_types: Sequence[str]) -> int:
    """The channels :func:`pool_ops` returns for ``width``-wide views."""
    return width * sum(p in pool_types for p in ("max", "mean", "var"))


class MLPUNetFusion(nn.Module):
    """Per-view MLPUNet → masked view pooling → fusion MLP
    (keypointnerf_util.py:511-552). ``n_dims1[0]`` is the per-view
    encoding's width; ``n_dims2[0]`` is replaced by the pooled width."""

    def __init__(self, n_dims1: Sequence[int], n_dims2: Sequence[int],
                 skip_dims: Sequence[int], skip_layers: Sequence[int],
                 nl_layer: str = "softplus", weight_norm: bool = True,
                 pool_types: Sequence[str] = ("mean",)):
        super().__init__()
        self.pool_types = tuple(pool_types)
        self.layers1 = MLPUNet(n_dims1, skip_dims, skip_layers, nl_layer,
                               weight_norm)
        dims2 = (pool_width(n_dims1[-1], pool_types),) + tuple(n_dims2[1:])
        self.layers2 = MLP(dims2, (), nl_layer, weight_norm)

    def forward(self, x, feats: List[torch.Tensor], a, w=None):
        """x: (B, V, N, C) spatial encoding; feats: list of (B, V, N, Fi);
        a: (B, V, N, 1) mask; w: (B, V, N, 1) weights.
        Returns (out, valid, x_view, x_pool)."""
        x_view = self.layers1(x, feats)
        a_sum = torch.sum(a, dim=1)
        if w is None:
            w = a / (a_sum[:, None] + 1e-6)
        x_pool = pool_ops(x_view, self.pool_types, w)
        valid = a_sum > 0.0
        return self.layers2(x_pool), valid, x_view, x_pool


# --------------------------------------------------------------- conv nets

class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: weight (O, I, k, k), optional bias;
    ``padding`` is symmetric per side ("VALID" is 0)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding = stride, padding

    def reset_parameters(self, generator):
        with torch.no_grad():
            lecun_normal_(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(32, C))`` on NCHW: ε = 1e-6 and
    flax's statistics, var = max(0, E[x²] − E[x]²), then
    (x − mean) · (rsqrt(var + ε) · scale) + bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        N, C, H, W = x.shape
        xg = x.reshape(N, self.groups, -1)
        mean = xg.mean(dim=-1, keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xg - mean).reshape(N, C, H, W)
        mul = torch.rsqrt(var + 1e-6).expand(
            N, self.groups, C // self.groups).reshape(N, C, 1, 1)
        mul = mul * self.weight[:, None, None]
        return y * mul + self.bias[:, None, None]


def _avg_pool2(x):
    return F.avg_pool2d(x, 2, 2)


def zero_interleave(x):
    """``lax.pad`` with (1, 2, 1) on H and W of NCHW: a zero between
    neighbours, one zero before, two after → (N, C, 2H + 2, 2W + 2). A
    VALID 3×3 convolution of it is the reference's k3/s2 transposed
    convolution (output 2H × 2W)."""
    N, C, H, W = x.shape
    z = x.new_zeros(N, C, 2 * H + 2, 2 * W + 2)
    z[:, :, 1:2 * H:2, 1:2 * W:2] = x
    return z


class HGConvBlock(nn.Module):
    """Pre-activation 3-branch conv block (keypointnerf_util.py:451-509)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        op = out_planes
        self.bn1 = GroupNorm(in_planes)
        self.conv1 = Conv(in_planes, op // 2, 3, padding=1, bias=False)
        self.bn2 = GroupNorm(op // 2)
        self.conv2 = Conv(op // 2, op // 4, 3, padding=1, bias=False)
        self.bn3 = GroupNorm(op // 4)
        self.conv3 = Conv(op // 4, op // 4, 3, padding=1, bias=False)
        self.has_downsample = in_planes != op
        if self.has_downsample:
            self.bn4 = GroupNorm(in_planes)
            self.downsample_conv = Conv(in_planes, op, 1, bias=False)

    def forward(self, x):
        h1 = self.conv1(torch.relu(self.bn1(x)))
        h2 = self.conv2(torch.relu(self.bn2(h1)))
        h3 = self.conv3(torch.relu(self.bn3(h2)))
        out = torch.cat([h1, h2, h3], dim=1)
        res = (self.downsample_conv(torch.relu(self.bn4(x)))
               if self.has_downsample else x)
        return out + res


class HourGlass(nn.Module):
    """Recursive hourglass with a bicubic skip upsample
    (keypointnerf_util.py:296-343); blocks named as flax's, ``b1_{lv}``,
    ``b2_{lv}``, ``b2_plus_1``, ``b3_{lv}``."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            for name in ("b1", "b2", "b3"):
                self.add_module(f"{name}_{lv}",
                                HGConvBlock(features, features))
        self.add_module("b2_plus_1", HGConvBlock(features, features))

    def _level(self, lv, x):
        up1 = getattr(self, f"b1_{lv}")(x)
        low = getattr(self, f"b2_{lv}")(_avg_pool2(x))
        low = (self._level(lv - 1, low) if lv > 1
               else self.b2_plus_1(low))
        low = getattr(self, f"b3_{lv}")(low)
        up2 = resize_bicubic_align_corners(
            low, low.shape[-2] * 2, low.shape[-1] * 2, axes=(-2, -1))
        return up1 + up2

    def forward(self, x):
        return self._level(self.depth, x)


class DeconvReLUGroup(nn.Module):
    """k3/s2 transposed conv + GroupNorm + ReLU (keypointnerf_util.py:
    346-355), as the JAX package writes it: :func:`zero_interleave` and a
    VALID 3×3 convolution."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, 3, bias=False)
        self.norm = GroupNorm(out_ch)

    def forward(self, x):
        return torch.relu(self.norm(self.conv(zero_interleave(x))))


class HGFilterV2(nn.Module):
    """Stacked-hourglass geometry encoder (keypointnerf_util.py:357-449).

    Input (N, H, W, 3) in [-1, 1]. Returns [coarse (N, H/4, W/4, out_ch),
    x_hd (N, H, W, 8)], channels-last: the two skip-feature levels the
    fusion MLP reads.
    """

    def __init__(self, out_ch: int = 64, n_stack: int = 1,
                 n_downsample: int = 4, out_ch_hd: int = HD_CH):
        super().__init__()
        self.n_stack = n_stack
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = GroupNorm(64)
        self.conv2 = HGConvBlock(64, 128)
        self.unpack1 = DeconvReLUGroup(128, 32)
        self.conv_out = Conv(32, out_ch_hd, 5, padding=2)
        self.conv3 = HGConvBlock(128, 128)
        self.conv4 = HGConvBlock(128, 256)
        for i in range(n_stack):
            self.add_module(f"m{i}", HourGlass(n_downsample, 256))
            self.add_module(f"top_m_{i}", HGConvBlock(256, 256))
            self.add_module(f"conv_last{i}", Conv(256, 256, 1))
            self.add_module(f"bn_end{i}", GroupNorm(256))
            self.add_module(f"l{i}", Conv(256, out_ch, 1))
            if i < n_stack - 1:
                self.add_module(f"bl{i}", Conv(256, 256, 1))
                self.add_module(f"al{i}", Conv(out_ch, 256, 1))

    def forward(self, x):
        h = self.conv1(x.permute(0, 3, 1, 2))
        h = self.conv2(torch.relu(self.bn1(h)))
        x_hd = self.conv_out(self.unpack1(h))
        h = self.conv4(self.conv3(_avg_pool2(h)))
        previous, out = h, None
        for i in range(self.n_stack):
            hg = getattr(self, f"m{i}")(previous)
            ll = getattr(self, f"top_m_{i}")(hg)
            ll = torch.relu(getattr(self, f"bn_end{i}")(
                getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.n_stack - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(out))
        return [out.permute(0, 2, 3, 1), x_hd.permute(0, 2, 3, 1)]


def _instance_norm(x):
    """InstanceNorm2d(affine=False) of NCHW: per sample and channel over
    H, W, two-pass variance, ε = 1e-5."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


def _rep_pad(x, p: int):
    return F.pad(x, (p, p, p, p), mode="replicate")


class ResBlkEncoder(nn.Module):
    """Texture feature encoder (keypointnerf_util.py:251-294): instance-norm
    conv encoder, residual blocks, transposed-conv upsampling (written as
    :func:`zero_interleave` and a VALID convolution). (N, H, W, 3) →
    (N, H·2^(up−down), ·, out_ch), channels-last."""

    def __init__(self, out_ch: int = 8, ngf: int = 64, n_downsample: int = 3,
                 n_blocks: int = 4, n_upsample: int = 2):
        super().__init__()
        self.n_downsample, self.n_blocks = n_downsample, n_blocks
        self.n_upsample = n_upsample
        self.conv_in = Conv(3, ngf, 7)
        for i in range(n_downsample):
            mult = 2 ** i
            self.add_module(f"down_{i}", Conv(ngf * mult, ngf * mult * 2, 3,
                                              stride=2, padding=1))
        ch = ngf * 2 ** n_downsample
        for i in range(n_blocks):
            self.add_module(f"res_{i}_conv1", Conv(ch, ch, 3))
            self.add_module(f"res_{i}_conv2", Conv(ch, ch, 3))
        for i in range(n_upsample):
            mult = 2 ** (n_downsample - i)
            self.add_module(f"up_{i}", Conv(ngf * mult, ngf * mult // 2, 3))
        if n_upsample > 0:
            self.conv_out = Conv(ngf * 2 ** (n_downsample - n_upsample),
                                 out_ch, 7)

    def forward(self, x):
        h = self.conv_in(_rep_pad(x.permute(0, 3, 1, 2), 3))
        h = torch.relu(_instance_norm(h))
        for i in range(self.n_downsample):
            h = torch.relu(_instance_norm(getattr(self, f"down_{i}")(h)))
        for i in range(self.n_blocks):
            r = getattr(self, f"res_{i}_conv1")(_rep_pad(h, 1))
            r = torch.relu(_instance_norm(r))
            r = getattr(self, f"res_{i}_conv2")(_rep_pad(r, 1))
            h = h + _instance_norm(r)
        for i in range(self.n_upsample):
            h = getattr(self, f"up_{i}")(zero_interleave(h))
            h = torch.relu(_instance_norm(h))
        if self.n_upsample > 0:
            h = self.conv_out(_rep_pad(h, 3))
        return h.permute(0, 2, 3, 1)


class IBRRenderingHead(nn.Module):
    """IBRNet-style colour head (keypointnerf.py:1292-1355): anisotropy-
    weighted mean/variance fusion, visibility refinement, per-view softmax
    colour blending. ``feat_ch`` is the width of its ``rgb_feats`` (3 +
    texture + compressed geometry channels)."""

    def __init__(self, in_channels: int = 32, feat_ch: int = 35):
        super().__init__()
        d = in_channels + 3
        self.ani_al = nn.Parameter(torch.tensor(0.2))
        self._seq("ray_encoder", (4, 16, d))
        self._seq("base_layer", (3 * feat_ch, 64, 32))
        self._seq("vis_layer1", (32, 32, 33))
        self._seq("vis_layer2", (32, 32, 1))
        self._seq("out_layer", (32 + 1 + 4, 16, 8, 1))

    def _seq(self, name, dims):
        for i in range(len(dims) - 1):
            self.add_module(f"{name}_{i}", Dense(dims[i], dims[i + 1]))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.ani_al.fill_(0.2)

    def _run(self, name, n, x, last_act=True):
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x)
            if last_act or i < n - 1:
                x = F.elu(x)
        return x

    def forward(self, rgb_feats, ray_diffs, proj_mask):
        """rgb_feats (R, S, V, 3+F), ray_diffs (R, S, V, 4),
        proj_mask (R, S, V, 1) → colour (R, S, 3)."""
        dir_feat = self._run("ray_encoder", 2, ray_diffs)
        src_rgb = rgb_feats[..., :3]
        d = dir_feat.shape[-1]
        rgb_feats = torch.cat([rgb_feats[..., :d] + dir_feat,
                               rgb_feats[..., d:]], dim=-1)

        dot = ray_diffs[..., 3:4]
        exp_dot = torch.exp(torch.abs(self.ani_al) * (dot - 1.0))
        weight = (exp_dot - torch.amin(exp_dot, dim=2, keepdim=True)) \
            * proj_mask
        weight = weight / (torch.sum(weight, dim=2, keepdim=True) + 1e-8)

        mean = torch.sum(rgb_feats * weight, dim=2, keepdim=True)
        var = torch.sum(weight * (rgb_feats - mean) ** 2, dim=2,
                        keepdim=True)
        fused = torch.cat([mean, var], dim=-1)
        V = rgb_feats.shape[2]
        x = self._run("base_layer", 2, torch.cat(
            [fused.expand(-1, -1, V, -1), rgb_feats], dim=-1))

        pred_vis = self._run("vis_layer1", 2, x * weight)
        res, vis = pred_vis[..., :-1], pred_vis[..., -1:]
        x = x + res
        vis = torch.sigmoid(self.vis_layer2_1(F.elu(self.vis_layer2_0(
            x * torch.sigmoid(vis) * proj_mask)))) * proj_mask

        h = torch.cat([x, vis, ray_diffs], dim=-1)
        h = F.elu(self.out_layer_0(h))
        h = F.elu(self.out_layer_1(h))
        logits = self.out_layer_2(h)
        logits = torch.where(proj_mask == 0, torch.full_like(logits, -1e9),
                             logits)
        return torch.sum(src_rgb * torch.softmax(logits, dim=2), dim=2)


def keypoint_position_embedding(x, nlevels: int, scale: float = 1.0):
    """KeypointNeRF PE layout (spatial_encoder.py:24-47): per level l,
    [sin(f_l·x) (C), cos(f_l·x) (C)], prefixed by x itself."""
    if nlevels <= 0:
        return x
    freqs = scale * math.pi * (2.0 ** torch.arange(
        nlevels, dtype=x.dtype, device=x.device))
    y = x[..., None, :] * freqs[:, None]  # (..., L, C)
    z = torch.cat([torch.sin(y), torch.cos(y)], dim=-1)  # (..., L, 2C)
    return torch.cat([x, z.reshape(x.shape[:-1] + (-1,))], dim=-1)


def rel_z_decay_encoding(cxyz, kpt_cam, sp_level: int, scale: float,
                         sigma: float):
    """``rel_z_decay`` spatial keypoint encoding (spatial_encoder.py:
    108-117): per-keypoint camera-z differences, positionally encoded, times
    a Gaussian falloff on the 3-D keypoint distance.

    cxyz: (BV, N, 3) camera-space points; kpt_cam: (BV, K, 3) camera-space
    keypoints. Returns (BV, N, (1+2·sp_level)·K).
    """
    dz = scale * (cxyz[:, :, None, 2] - kpt_cam[:, None, :, 2])  # (BV,N,K)
    dxyz = cxyz[:, :, None] - kpt_cam[:, None]
    w = torch.exp(-torch.sum(dxyz ** 2, dim=-1) / (2.0 * sigma ** 2))
    out = keypoint_position_embedding(dz, sp_level)  # (BV, N, (1+2L)·K)
    K = kpt_cam.shape[1]
    out = out.reshape(out.shape[:2] + (-1, K)) * w[:, :, None]
    return out.reshape(out.shape[:2] + (-1,))
