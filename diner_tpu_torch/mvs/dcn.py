"""Deformable convolution v2 as bilinear row gathers + per-tap matmuls.

Port of ``diner_tpu/mvs/dcn.py`` (reference ``deps/TransMVSNet/models/
dcn.py``: DCNv2 with a zero-initialised offset+mask conv feeding
``torchvision.ops.deform_conv2d``). Each of the 9 taps samples the input
bilinearly at its offset position (zeros outside) with the sigmoid mask
folded into the corner weights in f32, and its (N·H·W, C) × (C, O) product
is summed across taps in f32. The 4 corner fetches of a tap are flat row
gathers (kernel C on the card, ``ops/gather_cuda.py``): 36 per layer.

The sampler's gradient is the JAX package's hand-written VJP
(``_bilinear_sample_pix``): a ``torch.autograd.Function`` that saves only
the image, the positions and the mask, whose backward is a CUDA kernel on
the card (``ops/dcn_cuda.py``, ``csrc/dcn_sample_bwd.cu``). Autograd of
the corner gathers would instead keep each tap's 4 gathered row blocks for
the backward (``DCN_CUSTOM_VJP = False``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diner_tpu_torch.mvs.blocks import Conv2d
from diner_tpu_torch.ops.dcn_cuda import bilinear_sample_pix_bwd, corner_meta
from diner_tpu_torch.ops.gather_cuda import row_gather


def _sample(img, x, y, scale):
    """The sampler's forward (see :func:`bilinear_sample_pix`)."""
    N, H, W, C = img.shape
    P = x.shape[1]
    flat = img.reshape(N * H * W, C)
    corners, _ = corner_meta(img.shape, x, y, scale)
    out = None
    for idx, w, _, _ in corners:
        rows = row_gather(flat, idx.reshape(-1)).reshape(N, P, C)
        term = rows * w.to(img.dtype)[..., None]
        out = term if out is None else out + term
    return out


class _BilinearSamplePix(torch.autograd.Function):
    """Forward: the 4 corner fetches through kernel C. Backward:
    ``ops/dcn_cuda.py:bilinear_sample_pix_bwd`` (the kernel on the card,
    the plain version on the CPU), from the saved ``img, x, y, scale``
    alone."""

    @staticmethod
    def forward(ctx, img, x, y, scale):
        ctx.save_for_backward(img, x, y, scale)
        return _sample(img, x, y, scale)

    @staticmethod
    def backward(ctx, g):
        img, x, y, scale = ctx.saved_tensors
        d_img, d_x, d_y, d_s = bilinear_sample_pix_bwd(
            img, x, y, scale, g.contiguous())
        return (d_img, d_x.to(x.dtype), d_y.to(y.dtype),
                None if d_s is None else d_s.to(scale.dtype))


# The sampler's gradient: True, the hand-written backward
# (:class:`_BilinearSamplePix`, which saves the image and the positions);
# False, autograd of the corner gathers (the JAX package's default), which
# saves each tap's 4 gathered (N·P, C) row blocks for the weight products.
DCN_CUSTOM_VJP = True


def bilinear_sample_pix(img, x, y, scale=None):
    """Bilinear sample at unnormalised pixel positions, zeros outside.

    img: (N, H, W, C) contiguous; x, y: (N, P), taken in f32 (integer pixel
    indices above 256 are not exact in bf16). ``scale`` is an optional
    (N, P) multiplier (the DCNv2 mask) folded into each corner weight in
    f32, which is then cast to ``img.dtype`` once. Returns (N, P, C); the
    4 corner terms are summed in corner order, as in JAX. Differentiable in
    all four inputs, by :class:`_BilinearSamplePix` or by autograd as
    ``DCN_CUSTOM_VJP`` says.
    """
    if DCN_CUSTOM_VJP:
        return _BilinearSamplePix.apply(img, x, y, scale)
    return _sample(img, x, y, scale)


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
        self.conv_offset_mask = Conv2d(in_channels, 3 * K, kernel,
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
