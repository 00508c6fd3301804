"""Feature-Matching Transformer (linear attention), channels-first maps.

Port of ``diner_tpu/mvs/fmt.py`` (reference ``deps/TransMVSNet/models/
FMT.py`` + ``position_encoding.py``): ELU+1 linear attention, the
['self', 'cross'] × 4 layer sequence at stage 1, and the pathway that
carries its result down the feature pyramid (1×1 reduction, bilinear
upsample-add, 3×3 smoothing). Module names follow the reference
(``FMT.layers.i.attention.query_projection``, ``FMT.pos_encoding.kenc.
encoder.j``, ``dim_reduction_1``, ``smooth_1``). LayerNorm takes flax's
epsilon, 1e-6, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.blocks import Conv2d, LayerNorm, Linear
from diner_tpu_torch.utils.resize import resize_linear_2d


def linear_attention(q, k, v, eps: float = 1e-6):
    """ELU+1 linear attention. q: (N, L, H, D), k/v: (N, S, H, D/M)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    kv = torch.einsum("nshd,nshm->nhmd", K, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhmd,nlh->nlhm", Q, kv, z)


class AttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        dk = d_model // n_heads
        self.query_projection = Linear(d_model, dk * n_heads)
        self.key_projection = Linear(d_model, dk * n_heads)
        self.value_projection = Linear(d_model, dk * n_heads)
        self.out_projection = Linear(dk * n_heads, d_model)

    def forward(self, queries, keys, values):
        N, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        q = self.query_projection(queries).reshape(N, L, H, -1)
        k = self.key_projection(keys).reshape(N, S, H, -1)
        v = self.value_projection(values).reshape(N, S, H, -1)
        return self.out_projection(linear_attention(q, k, v).reshape(N, L, -1))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.attention = AttentionLayer(d_model, n_heads)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.linear1 = Linear(d_model, 2 * d_model)
        self.linear2 = Linear(2 * d_model, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-6)

    def forward(self, x, source):
        x = self.norm1(x + self.attention(x, source, source))
        y = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2(x + y)


def sine_position_encoding_2d(d_model: int, H: int, W: int,
                              dtype=torch.float32, device=None):
    """LoFTR-style 2-D sine PE (temp_bug_fix variant), (H, W, d_model)."""
    ys = torch.arange(1, H + 1, dtype=dtype, device=device)[:, None].expand(
        H, W)
    xs = torch.arange(1, W + 1, dtype=dtype, device=device)[None].expand(H, W)
    div = torch.exp(torch.arange(0, d_model // 2, 2, dtype=dtype,
                                 device=device)
                    * (-math.log(10000.0) / (d_model // 2)))
    pe = torch.zeros((H, W, d_model), dtype=dtype, device=device)
    pe[..., 0::4] = torch.sin(xs[..., None] * div)
    pe[..., 1::4] = torch.cos(xs[..., None] * div)
    pe[..., 2::4] = torch.sin(ys[..., None] * div)
    pe[..., 3::4] = torch.cos(ys[..., None] * div)
    return pe


class _KeypointEncoder(nn.Module):
    """The reference's ``KeypointEncoder``: a Conv1d(k=1) + BN + ReLU MLP
    [2] + layers + [d_model], no BN/ReLU after the last, its bias zero."""

    def __init__(self, d_model: int, layers: Sequence[int]):
        super().__init__()
        chans = [2, *layers, d_model]
        mods: list = []
        for i in range(1, len(chans)):
            mods.append(nn.Conv1d(chans[i - 1], chans[i], 1))
            if i < len(chans) - 1:
                mods += [nn.BatchNorm1d(chans[i]), nn.ReLU()]
        self.encoder = nn.Sequential(*mods)
        nn.init.zeros_(self.encoder[-1].bias)

    def forward(self, kpts):
        return self.encoder(kpts)


class PositionEncodingSuperGlue(nn.Module):
    """SuperGlue-style learned positional encoding (reference
    ``position_encoding.py:6-21``): pixel keypoints normalised by
    ``(kpts − size/2) / (0.7·max(W, H))`` through the keypoint MLP, added to
    the (N, C, H, W) map."""

    def __init__(self, d_model: int = 32, mlp_layers: Sequence[int] = (32, 64)):
        super().__init__()
        self.kenc = _KeypointEncoder(d_model, mlp_layers)

    def forward(self, x):
        N, C, H, W = x.shape
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=x.device),
            torch.arange(W, dtype=torch.float32, device=x.device),
            indexing="ij")
        size = torch.tensor([W, H], dtype=torch.float32, device=x.device)
        kpts = torch.stack([xs, ys], dim=-1)  # (H, W, 2)
        p = (kpts - size / 2.0) / (0.7 * size.max())
        h = self.kenc(p.reshape(1, H * W, 2).transpose(1, 2))
        return x + h.reshape(1, C, H, W).to(x.dtype)

    def train(self, mode: bool = True):
        # the JAX package runs this MLP's BN on its running statistics,
        # training or not (fmt.py: the encoding is called with train=False)
        super().train(mode)
        self.kenc.eval()
        return self


class FMT(nn.Module):
    """Ref path: the self-attention layers, each output kept; src path:
    self / cross(ref) layers in turn. Maps are (N, C, H, W).

    ``pe_type``: 'sine' (the reference's default, ``FMT.py:126``) or
    'superglue' (``FMT.py:125``)."""

    def __init__(self, d_model: int = 32, n_heads: int = 8,
                 layer_names: Sequence[str] = ("self", "cross") * 4,
                 pe_type: str = "sine"):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.pe_type = pe_type
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads)
                                    for _ in self.layer_names)
        if pe_type == "superglue":
            self.pos_encoding = PositionEncodingSuperGlue(d_model)
        elif pe_type != "sine":
            raise ValueError(f"unknown pe_type {pe_type!r}")

    def _flatten_pe(self, feat):
        N, C, H, W = feat.shape
        if self.pe_type == "superglue":
            feat = self.pos_encoding(feat)
        else:
            pe = sine_position_encoding_2d(C, H, W, feat.dtype, feat.device)
            feat = feat + pe.permute(2, 0, 1)
        return feat.flatten(2).transpose(1, 2)  # (N, H·W, C)

    @staticmethod
    def _unflatten(x, shape):
        N, C, H, W = shape
        return x.transpose(1, 2).reshape(N, C, H, W)

    def ref_forward(self, ref_feature) -> List[torch.Tensor]:
        x = self._flatten_pe(ref_feature)
        outs = []
        for layer, name in zip(self.layers, self.layer_names):
            if name == "self":
                x = layer(x, x)
                outs.append(self._unflatten(x, ref_feature.shape))
        return outs

    def src_forward(self, ref_feature_list, src_feature):
        refs = [r.flatten(2).transpose(1, 2) for r in ref_feature_list]
        x = self._flatten_pe(src_feature)
        for i, (layer, name) in enumerate(zip(self.layers, self.layer_names)):
            if name == "self":
                x = layer(x, x)
            elif name == "cross":
                x = layer(x, refs[i // 2])
            else:
                raise KeyError(name)
        return self._unflatten(x, src_feature.shape)


class FMTWithPathway(nn.Module):
    """FMT at stage 1, carried down the feature pyramid."""

    def __init__(self, base_channels: int = 8, pe_type: str = "sine"):
        super().__init__()
        bc = base_channels
        self.FMT = FMT(d_model=4 * bc, pe_type=pe_type)
        self.dim_reduction_1 = Conv2d(4 * bc, 2 * bc, 1, bias=False)
        self.dim_reduction_2 = Conv2d(2 * bc, bc, 1, bias=False)
        self.smooth_1 = Conv2d(2 * bc, 2 * bc, 3, padding=1, bias=False)
        self.smooth_2 = Conv2d(bc, bc, 3, padding=1, bias=False)

    @staticmethod
    def _upsample_add(x, y):
        H, W = y.shape[-2:]
        return resize_linear_2d(x, H, W, axes=(-2, -1)) + y

    def forward(self, features: List[dict]) -> List[dict]:
        """features: per-view dicts {"stage1", "stage2", "stage3"}."""
        out = []
        ref_list = None
        for vi, f in enumerate(features):
            f = dict(f)
            if vi == 0:
                ref_list = self.FMT.ref_forward(f["stage1"])
                f["stage1"] = ref_list[-1]
            else:
                f["stage1"] = self.FMT.src_forward(ref_list, f["stage1"])
            f["stage2"] = self.smooth_1(self._upsample_add(
                self.dim_reduction_1(f["stage1"]), f["stage2"]))
            f["stage3"] = self.smooth_2(self._upsample_add(
                self.dim_reduction_2(f["stage2"]), f["stage3"]))
            out.append(f)
        return out
