"""Point-wise grid sampling on channels-last images.

Port of ``diner_tpu/ops/grid_sample.py``: images are (N, H, W, C), queries
(N, P, 2) normalized [x, y] in [-1, 1], ``align_corners=False``. Nearest rounds half to even (``torch.round``, as ``jnp.round``).
Exponential padding is analytic: no padded canvas is built.

``F.grid_sample`` is not used: it takes NCHW images, and its bilinear
weights and border handling differ in rounding from the JAX package's.
``grid_sample_bilinear_imggrad`` carries the JAX package's hand-written
image-only backward (``_gs_bilinear_bwd``). Every pixel fetch is one
``index_select`` of the flattened image's rows.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size):
    """[-1, 1] → pixel coordinate (torch conventions)."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather_pixels(img, ix, iy):
    """img[n, iy, ix, :] for in-bounds integer maps (N, P) → (N, P, C).

    One flat row gather on (N·H·W, C), a view of a contiguous image.
    """
    N, H, W, C = img.shape
    base = (torch.arange(N, device=img.device) * (H * W))[:, None]
    idx = (base + iy.long() * W + ix.long()).reshape(-1)
    return img.reshape(N * H * W, C).index_select(0, idx).reshape(
        N, ix.shape[-1], C)


def grid_sample_nearest(img, uv, padding_mode: str = "border"):
    """Nearest-neighbour point sampling, "border" or "zeros" padding."""
    N, H, W, C = img.shape
    x = _unnormalize(uv[..., 0], W)
    y = _unnormalize(uv[..., 1], H)
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    ix = torch.round(x).long()
    iy = torch.round(y).long()
    out = _gather_pixels(img, ix.clamp(0, W - 1), iy.clamp(0, H - 1))
    if padding_mode == "zeros":
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out


def _bilinear_corners(img_shape, uv):
    """The 4 corners' clipped indices and weights, as (ix, iy, w) triples,
    with "border" padding."""
    N, H, W, C = img_shape
    x = _unnormalize(uv[..., 0], W).clamp(0.0, W - 1)
    y = _unnormalize(uv[..., 1], H).clamp(0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.long()
    y0i = y0.long()
    return [(ix.clamp(0, W - 1), iy.clamp(0, H - 1), wgt) for ix, iy, wgt in (
        (x0i, y0i, (1.0 - wx1) * (1.0 - wy1)),
        (x0i + 1, y0i, wx1 * (1.0 - wy1)),
        (x0i, y0i + 1, (1.0 - wx1) * wy1),
        (x0i + 1, y0i + 1, wx1 * wy1),
    )]


def grid_sample_bilinear(img, uv):
    """Bilinear point sampling with "border" padding: the forward of the
    JAX package's ``grid_sample_bilinear_imggrad``.

    Corner weights are cast to the image dtype and the 4 terms are summed
    in corner order, so a bf16 latent gives a bf16 result as in JAX.
    """
    out = None
    for ix, iy, wgt in _bilinear_corners(img.shape, uv):
        term = _gather_pixels(img, ix, iy) * wgt[..., None].to(img.dtype)
        out = term if out is None else out + term
    return out


class _BilinearImgGrad(torch.autograd.Function):
    """Forward: :func:`grid_sample_bilinear`. Backward: scatter-add of
    ``g · w_corner`` into an f32 (N·H·W, C) canvas, cast to the image
    dtype once; no uv gradient."""

    @staticmethod
    def forward(ctx, img, uv):
        ctx.save_for_backward(uv)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        return grid_sample_bilinear(img, uv)

    @staticmethod
    def backward(ctx, g):
        uv, = ctx.saved_tensors
        N, H, W, C = ctx.img_shape
        base = (torch.arange(N, device=uv.device) * (H * W))[:, None]
        acc = torch.zeros((N * H * W, C), dtype=torch.float32,
                          device=g.device)
        g32 = g.float()
        for ix, iy, wgt in _bilinear_corners(ctx.img_shape, uv):
            idx = (base + iy * W + ix).reshape(-1)
            acc.index_add_(0, idx, (g32 * wgt[..., None].float()
                                    ).reshape(-1, C))
        d_img = acc.reshape(N, H, W, C).to(ctx.img_dtype)
        return d_img, None


def grid_sample_bilinear_imggrad(img, uv):
    """Bilinear point sampling with the JAX package's image-only VJP
    (``diner_tpu/ops/grid_sample.py:189-269``).

    Forward as :func:`grid_sample_bilinear`. The backward returns no uv
    gradient (on the DINER path the coordinates come from the sampler,
    which stops their gradient) and accumulates the image gradient in f32,
    so a bf16 latent's gradient is summed in f32 and rounded once, where
    autograd of the row gather would sum it in bf16. The JAX package's
    channels-major branch for C ≤ 32 is a TPU layout choice with the same
    values and has no counterpart here.
    """
    return _BilinearImgGrad.apply(img, uv)


def exponential_pad_mult(ix, iy, H, W, pad_size, double_width, dtype):
    """Exponential-padding factor at unpadded nearest indices:
    ``2^(max(overhang − 1, 0)/double_width)`` with the per-axis max in
    corners, zero outside the ``pad_size``-padded canvas."""
    zero = torch.zeros_like(ix)
    dx = torch.maximum(torch.maximum(-ix, ix - (W - 1)), zero)
    dy = torch.maximum(torch.maximum(-iy, iy - (H - 1)), zero)
    exponent = torch.maximum(torch.maximum(dx - 1, zero),
                             torch.maximum(dy - 1, zero)).to(dtype)
    in_padded = (dx <= pad_size) & (dy <= pad_size)
    return torch.where(in_padded, torch.exp2(exponent / double_width),
                       torch.zeros_like(exponent))


def grid_sample_exponential_nearest(img, uv, pad_size: int = 100,
                                    double_width: float = 12.0):
    """Nearest sampling with analytic exponential border extrapolation;
    zero outside the padded canvas. (N, H, W, C) × (N, P, 2) → (N, P, C)."""
    N, H, W, C = img.shape
    ix = torch.round(_unnormalize(uv[..., 0], W)).long()
    iy = torch.round(_unnormalize(uv[..., 1], H)).long()
    mult = exponential_pad_mult(ix, iy, H, W, pad_size, double_width,
                                img.dtype)
    base = _gather_pixels(img, ix.clamp(0, W - 1), iy.clamp(0, H - 1))
    return base * mult[..., None]
