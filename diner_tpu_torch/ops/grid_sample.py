"""Point-wise grid sampling on channels-last images.

Port of ``diner_tpu/ops/grid_sample.py``: images are (N, H, W, C), queries
(N, P, 2) normalized [x, y] in [-1, 1], ``align_corners=False`` unless
stated. Nearest rounds half to even (``torch.round``, as ``jnp.round``).
Exponential padding is analytic: no padded canvas is built.

``F.grid_sample`` is not used: it takes NCHW images, and its bilinear
weights and border handling differ in rounding from the JAX package's.
``grid_sample_bilinear_imggrad`` carries the JAX package's hand-written
image-only backward (``_gs_bilinear_bwd``). Every pixel fetch is one flat
row gather (kernel C on the card, ``ops/gather_cuda.py``); the wide-row
pair table (``build_pair_table``, ``grid_sample_bilinear_pairs``) fetches
both x-corners of a lookup as one row.
"""

from __future__ import annotations

import torch

from diner_tpu_torch.ops.gather_cuda import row_gather


def _unnormalize(coord, size, align_corners: bool = False):
    """[-1, 1] → pixel coordinate (torch conventions)."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather_pixels(img, ix, iy):
    """img[n, iy, ix, :] for in-bounds integer maps (N, P) → (N, P, C).

    One flat row gather on (N·H·W, C), a view of a contiguous image.
    """
    N, H, W, C = img.shape
    base = (torch.arange(N, device=img.device) * (H * W))[:, None]
    idx = (base + iy.long() * W + ix.long()).reshape(-1)
    return row_gather(img.reshape(N * H * W, C), idx).reshape(
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


def _bilinear_corners(img_shape, uv, padding_mode: str,
                      align_corners: bool = False):
    """The 4 corners' clipped indices and weights, as (ix, iy, w) triples
    (weights zeroed for out-of-bounds corners in "zeros" mode)."""
    N, H, W, C = img_shape
    x = _unnormalize(uv[..., 0], W, align_corners)
    y = _unnormalize(uv[..., 1], H, align_corners)
    if padding_mode == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.long()
    y0i = y0.long()
    out = []
    for ix, iy, wgt in (
        (x0i, y0i, (1.0 - wx1) * (1.0 - wy1)),
        (x0i + 1, y0i, wx1 * (1.0 - wy1)),
        (x0i, y0i + 1, (1.0 - wx1) * wy1),
        (x0i + 1, y0i + 1, wx1 * wy1),
    ):
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
        out.append((ix.clamp(0, W - 1), iy.clamp(0, H - 1), wgt))
    return out


def grid_sample_bilinear(img, uv, padding_mode: str = "border",
                         align_corners: bool = False):
    """Bilinear point sampling: the forward of the JAX package's
    ``grid_sample_bilinear_imggrad``.

    Corner weights are cast to the image dtype and the 4 terms are summed
    in corner order, so a bf16 latent gives a bf16 result as in JAX.
    """
    out = None
    for ix, iy, wgt in _bilinear_corners(img.shape, uv, padding_mode,
                                         align_corners):
        term = _gather_pixels(img, ix, iy) * wgt[..., None].to(img.dtype)
        out = term if out is None else out + term
    return out


class _BilinearImgGrad(torch.autograd.Function):
    """Forward: :func:`grid_sample_bilinear`. Backward: scatter-add of
    ``g · w_corner`` into an f32 (N·H·W, C) canvas, cast to the image
    dtype once; no uv gradient."""

    @staticmethod
    def forward(ctx, img, uv, padding_mode, align_corners):
        ctx.save_for_backward(uv)
        ctx.img_shape, ctx.img_dtype = img.shape, img.dtype
        ctx.padding_mode, ctx.align_corners = padding_mode, align_corners
        return grid_sample_bilinear(img, uv, padding_mode, align_corners)

    @staticmethod
    def backward(ctx, g):
        uv, = ctx.saved_tensors
        N, H, W, C = ctx.img_shape
        base = (torch.arange(N, device=uv.device) * (H * W))[:, None]
        acc = torch.zeros((N * H * W, C), dtype=torch.float32,
                          device=g.device)
        g32 = g.float()
        for ix, iy, wgt in _bilinear_corners(ctx.img_shape, uv,
                                             ctx.padding_mode,
                                             ctx.align_corners):
            idx = (base + iy * W + ix).reshape(-1)
            acc.index_add_(0, idx, (g32 * wgt[..., None].float()
                                    ).reshape(-1, C))
        d_img = acc.reshape(N, H, W, C).to(ctx.img_dtype)
        return d_img, None, None, None


def grid_sample_bilinear_imggrad(img, uv, padding_mode: str = "border",
                                 align_corners: bool = False):
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
    return _BilinearImgGrad.apply(img, uv, padding_mode, align_corners)


def build_pair_table(img):
    """Parity-concatenated x-pair row table for wide-row bilinear lookups.

    (N, H, W, C) with even W → (N·H·W, 2C): rows are horizontally adjacent
    texel pairs. The first N·H·W/2 rows are the pairs starting at even x
    (the image itself, read two texels at a time); the rest start at odd x,
    and the last odd pair's right texel is a zero pad, only ever read with
    bilinear weight 0 ("border" clips x to W − 1). Written in place into
    one (2, N, H, W, C) buffer: 2× the image's bytes, no temporaries.
    """
    N, H, W, C = img.shape
    if W % 2:
        raise ValueError("pair table needs even W")
    pairs = img.new_empty((2, N, H, W, C))
    pairs[0] = img
    pairs[1, :, :, :W - 1] = img[:, :, 1:]
    pairs[1, :, :, W - 1] = 0
    return pairs.reshape(N * H * W, 2 * C)


def grid_sample_bilinear_pairs(pairs, img_shape, uv,
                               padding_mode: str = "border",
                               align_corners: bool = False):
    """Bilinear point sampling from a prebuilt pair table: two row fetches
    per point instead of four.

    Bit-identical to :func:`grid_sample_bilinear`: the same corner indices,
    the same per-corner weight products cast to the table dtype and the
    same order of the four terms. ``pairs`` comes from
    :func:`build_pair_table`, ``img_shape`` is the image's (N, H, W, C) and
    ``uv`` (N, P, 2) → (N, P, C). "border" padding only. Autograd works but
    scatters into the pair table; training keeps
    :func:`grid_sample_bilinear_imggrad`.
    """
    N, H, W, C = img_shape
    P = uv.shape[1]
    if padding_mode != "border":
        raise ValueError("pair-table sampling supports border mode only")
    x = _unnormalize(uv[..., 0], W, align_corners).clamp(0.0, W - 1)
    y = _unnormalize(uv[..., 1], H, align_corners).clamp(0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    x0i = x0.long()
    y0i = y0.long()
    y1i = torch.clamp(y0i + 1, max=H - 1)

    half = W // 2
    n_even = N * H * half
    nbase = (torch.arange(N, device=uv.device) * H)[:, None]
    even = x0i % 2 == 0

    def fetch(yy):
        base = (nbase + yy) * half
        # floor division: x0i = 0 gives −1 in the odd branch, which the
        # where discards before anything is gathered
        idx = torch.where(even, base + x0i // 2,
                          n_even + base + (x0i - 1) // 2)
        return row_gather(pairs, idx.reshape(-1)).reshape(N, P, 2, C)

    g0 = fetch(y0i)
    g1 = fetch(y1i)

    def w(wgt):  # the product and cast of the 4-corner path
        return wgt[..., None].to(pairs.dtype)

    return (g0[:, :, 0] * w((1.0 - wx1) * (1.0 - wy1))
            + g0[:, :, 1] * w(wx1 * (1.0 - wy1))
            + g1[:, :, 0] * w((1.0 - wx1) * wy1)
            + g1[:, :, 1] * w(wx1 * wy1))


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
