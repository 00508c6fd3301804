"""Deformable convolution v2 as bilinear row gathers + per-tap matmuls.

Port of ``diner_tpu/mvs/dcn.py`` (reference ``deps/TransMVSNet/models/
dcn.py``: DCNv2 with a zero-initialised offset+mask conv feeding
``torchvision.ops.deform_conv2d``). Each of the 9 taps samples the input
bilinearly at its offset position (zeros outside) with the sigmoid mask
folded into the corner weights in f32, and its (N·H·W, C) × (C, O) product
is summed across taps in f32. The 4 corner fetches of a tap are flat row
gathers (kernel C on the card, ``ops/gather_cuda.py``): 36 per layer.

The JAX package's hand-written VJP of the sampler (``_bilinear_sample_pix``,
off by default there) belongs to training and is not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diner_tpu_torch.ops.gather_cuda import row_gather


def bilinear_sample_pix(img, x, y, scale=None):
    """Bilinear sample at unnormalised pixel positions, zeros outside.

    img: (N, H, W, C) contiguous; x, y: (N, P), taken in f32 (integer pixel
    indices above 256 are not exact in bf16). ``scale`` is an optional
    (N, P) multiplier (the DCNv2 mask) folded into each corner weight in
    f32, which is then cast to ``img.dtype`` once. Returns (N, P, C); the
    4 corner terms are summed in corner order, as in JAX.
    """
    N, H, W, C = img.shape
    P = x.shape[1]
    x = x.float()
    y = y.float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    flat = img.reshape(N * H * W, C)
    base = (torch.arange(N, device=img.device) * (H * W))[:, None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(ix, iy, w):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        w = torch.where(valid, w, torch.zeros_like(w))
        if scale is not None:
            w = w * scale.float()
        idx = base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        rows = row_gather(flat, idx.reshape(-1)).reshape(N, P, C)
        return rows * w.to(img.dtype)[..., None]

    return (tap(x0i, y0i, (1 - wx1) * (1 - wy1))
            + tap(x0i + 1, y0i, wx1 * (1 - wy1))
            + tap(x0i, y0i + 1, (1 - wx1) * wy1)
            + tap(x0i + 1, y0i + 1, wx1 * wy1))


class DeformConv2d(nn.Module):
    """DCNv2, 3×3, stride 1, padding 1 (the only form the reference uses).

    Input (N, C, H, W) → (N, features, H, W). Parameters under the
    reference's names and layouts: ``weight`` (O, C, 3, 3), ``bias`` (O,),
    ``conv_offset_mask`` (a 3·9-channel conv: 18 offsets interleaved
    (dy, dx) per tap, then 9 mask logits).
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        K = kernel * kernel
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        self.conv_offset_mask = nn.Conv2d(in_channels, 3 * K, kernel,
                                          padding=kernel // 2)
        stdv = 1.0 / math.sqrt(in_channels * K)
        nn.init.uniform_(self.weight, -stdv, stdv)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)

    def forward(self, x):
        N, C, H, W = x.shape
        k = self.kernel
        K = k * k
        pad = k // 2
        om = self.conv_offset_mask(x).float()  # exact pixel math in f32
        off_y = om[:, 0:2 * K:2]  # (N, K, H, W)
        off_x = om[:, 1:2 * K:2]
        mask = torch.sigmoid(om[:, 2 * K:])
        img = x.permute(0, 2, 3, 1).contiguous()  # rows of C for the gathers
        kmat = self.weight.permute(2, 3, 1, 0).reshape(K, C, -1).to(x.dtype)
        gy = torch.arange(H, dtype=torch.float32, device=x.device)[:, None]
        gx = torch.arange(W, dtype=torch.float32, device=x.device)[None, :]
        out = None
        t = 0
        for dy in range(-pad, pad + 1):
            for dx in range(-pad, pad + 1):
                sy = gy + dy + off_y[:, t]  # (N, H, W)
                sx = gx + dx + off_x[:, t]
                s = bilinear_sample_pix(img, sx.reshape(N, -1),
                                        sy.reshape(N, -1),
                                        scale=mask[:, t].reshape(N, -1))
                term = torch.matmul(s, kmat[t]).float()  # (N, HW, O)
                out = term if out is None else out + term
                t += 1
        out = out.to(x.dtype) + self.bias.to(x.dtype)
        return out.reshape(N, H, W, -1).permute(0, 3, 1, 2)
