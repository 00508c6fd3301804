"""The DCN sampler's backward as a CUDA kernel, and its plain version.

``csrc/dcn_sample_bwd.cu`` replaces the JAX package's hand-written VJP of
the DCN sampler, ``diner_tpu/mvs/dcn.py:_bsp_bwd`` (with
``_bsp_bwd_rest``); its bound and design are in the source. The sampler
(``mvs/dcn.py:bilinear_sample_pix``) reads an (N, H, W, C) image at (N, P)
pixel positions (x, y), zeros outside, each corner weight times an optional
(N, P) ``scale`` in f32 and then rounded to the image dtype. Given the
output's cotangent g (N, P, C), the backward returns

- ``d_img``: Σ over points and corners of ``wq · g`` at the corner's row,
  summed in f32 and cast to the image dtype once (``wq`` the forward's
  rounded weight);
- ``d_x``, ``d_y``: from ``dw_k = Σ_c g · img[corner k]`` through the
  bilinear weights' derivatives, times ``scale``, 0 for corners off the
  image;
- ``d_scale``: ``Σ_k wbase_k · dw_k`` (None without ``scale``).

:func:`bilinear_sample_pix_bwd` runs the plain version,
:func:`bilinear_sample_pix_bwd_plain` (per-corner ``index_add_`` into an f32
canvas and ``(g · rows).sum(-1)``), for CPU tensors and launches the
kernel for CUDA ones, or raises. A DCN tap's call (P = H·W: the points are
the pixel grid plus offsets) takes the kernel's tap design, which sums the
canvas on chip a tile at a time and writes each row once, and adds the
corners that land beyond a tile's ring (:func:`spilled_corners`) in a
second launch; any other shape takes its point design (:func:`tiled`).
:func:`corner_meta` is the corner math the forward and both backwards
share. Both versions take ``f32_d_img``: ``d_img`` is then the f32 canvas
before its cast, so that a bf16 image's gradients can be compared before
one rounding hides the weights' own.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import cuda_build

# kernel launches since the count was last set to 0 (read by chip_smoke.py):
# two a call in the tap design (tiles, spill), one in the point design
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
             _P]
DTYPES = (torch.float32, torch.bfloat16)
# the tap design (csrc/dcn_sample_bwd.cu: kTileH, kTileW, kRing, kMaxTileC)
TILE_H, TILE_W = 8, 32
RING = 4
MAX_TILE_C = 32
MAX_VIEWS = 65535  # gridDim.y


@functools.cache
def _launcher():
    fn = cuda_build.load("dcn_sample_bwd").dcn_sample_bwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def corner_meta(img_shape, x, y, scale):
    """The 4 corners of each point as (flat row index (N, P) int64, f32
    weight with the off-image corners zeroed and ``scale`` folded in,
    validity, bilinear weight before both), in the order (x0, y0), (x0+1,
    y0), (x0, y0+1), (x0+1, y0+1); and (wx1, wy1). Positions are taken in
    f32."""
    N, H, W, _ = img_shape
    x = x.float()
    y = y.float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    base = (torch.arange(N, device=x.device) * (H * W))[:, None]
    x0i = x0.long()
    y0i = y0.long()
    corners = []
    for ix, iy, wb in ((x0i, y0i, (1 - wx1) * (1 - wy1)),
                       (x0i + 1, y0i, wx1 * (1 - wy1)),
                       (x0i, y0i + 1, (1 - wx1) * wy1),
                       (x0i + 1, y0i + 1, wx1 * wy1)):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        w = torch.where(valid, wb, torch.zeros_like(wb))
        if scale is not None:
            w = w * scale.float()
        idx = base + iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        corners.append((idx, w, valid, wb))
    return corners, (wx1, wy1)


def _rest(corners, dw, wx1, wy1, scale):
    """d_x, d_y, d_scale from the per-corner dot products ``dw``
    (``diner_tpu/mvs/dcn.py:_bsp_bwd_rest``)."""
    sc = scale.float() if scale is not None else torch.ones_like(wx1)
    zero = torch.zeros_like(wx1)
    dwb = [torch.where(c[2], d * sc, zero) for c, d in zip(corners, dw)]
    d_x = (-dwb[0] * (1 - wy1) + dwb[1] * (1 - wy1)
           - dwb[2] * wy1 + dwb[3] * wy1)
    d_y = (-dwb[0] * (1 - wx1) - dwb[1] * wx1
           + dwb[2] * (1 - wx1) + dwb[3] * wx1)
    d_scale = None
    if scale is not None:
        d_scale = sum(torch.where(c[2], c[3], zero) * d
                      for c, d in zip(corners, dw))
    return d_x, d_y, d_scale


def tiled(img_shape, P) -> bool:
    """Does a call take the kernel's tap design (two launches) rather than
    its point design (one)? The points must be the pixel grid (P = H·W)
    and a lane's share of a row (C / 4 channels) must fit its registers."""
    N, H, W, C = img_shape
    return (P == H * W and P < 2 ** 31 and C <= MAX_TILE_C
            and N <= MAX_VIEWS)


def spilled_corners(img_shape, x, y):
    """(N, P) bool per corner, in :func:`corner_meta`'s order: the valid
    corners of a tap-layout call (P = H·W, point p at pixel p) whose point
    lies beyond the ring of the tile that holds the corner, which the tap
    design adds in its second launch."""
    N, H, W, _ = img_shape
    pix = torch.arange(H * W, device=x.device)
    py, px = (pix // W)[None], (pix % W)[None]
    corners, _ = corner_meta(img_shape, x, y, None)
    out = []
    for idx, _, valid, _ in corners:
        q = idx % (H * W)
        ty = q // W // TILE_H * TILE_H
        tx = q % W // TILE_W * TILE_W
        ring = ((py >= ty - RING) & (py < ty + TILE_H + RING)
                & (px >= tx - RING) & (px < tx + TILE_W + RING))
        out.append(valid & ~ring)
    return out


def bilinear_sample_pix_bwd_plain(img, x, y, scale, g, f32_d_img=False):
    """The plain version: (d_img, d_x, d_y, d_scale) in torch ops."""
    N, H, W, C = img.shape
    P = x.shape[1]
    corners, (wx1, wy1) = corner_meta(img.shape, x, y, scale)
    flat = img.reshape(N * H * W, C)
    g32 = g.float()
    acc = torch.zeros((N * H * W, C), dtype=torch.float32, device=img.device)
    dw = []
    for idx, w, _, _ in corners:
        fi = idx.reshape(-1)
        rows = flat.index_select(0, fi).reshape(N, P, C).float()
        dw.append((g32 * rows).sum(-1))
        wq = w.to(img.dtype).float()
        acc.index_add_(0, fi, (g32 * wq[..., None]).reshape(-1, C))
    d_img = acc.reshape(N, H, W, C)
    if not f32_d_img:
        d_img = d_img.to(img.dtype)
    return (d_img,) + _rest(corners, dw, wx1, wy1, scale)


def _check(img, x, y, scale, g):
    if img.dim() != 4 or x.dim() != 2 or x.shape != y.shape or \
            x.shape[0] != img.shape[0]:
        raise ValueError(f"DCN sampler backward: img {tuple(img.shape)}, x "
                         f"{tuple(x.shape)}, y {tuple(y.shape)}; expected "
                         "(N, H, W, C) and (N, P)")
    if scale is not None and scale.shape != x.shape:
        raise ValueError(f"DCN sampler backward: scale {tuple(scale.shape)}"
                         f", expected {tuple(x.shape)}")
    if g.shape != x.shape + img.shape[-1:] or g.dtype != img.dtype:
        raise ValueError(f"DCN sampler backward: g {tuple(g.shape)} "
                         f"{g.dtype}, expected {tuple(x.shape)} + (C,) "
                         f"{img.dtype}")
    if img.dtype not in DTYPES:
        raise ValueError(f"DCN sampler backward: dtype {img.dtype} not "
                         "taken (float32 or bfloat16)")
    tensors = [img, x, y, g] + ([scale] if scale is not None else [])
    if any(t.device != img.device for t in tensors):
        raise ValueError("DCN sampler backward: tensors on several devices")


def bilinear_sample_pix_bwd_kernel(img, x, y, scale, g, f32_d_img=False):
    """Launch the kernel (CUDA tensors only): (d_img, d_x, d_y, d_scale),
    d_img in the image dtype (f32 with ``f32_d_img``), the rest f32."""
    global launches
    _check(img, x, y, scale, g)
    if img.device.type != "cuda":
        raise ValueError(f"DCN sampler backward kernel: tensors are on "
                         f"{img.device}, expected a CUDA device")
    N, H, W, C = img.shape
    P = x.shape[1]
    img = img.contiguous()
    g = g.contiguous()
    x = x.float().contiguous()
    y = y.float().contiguous()
    s = scale.float().contiguous() if scale is not None else None
    tap = tiled(img.shape, P)
    # the tap design writes every canvas row; the point design adds into it
    acc = (torch.empty if tap else torch.zeros)(
        (N * H * W, C), dtype=torch.float32, device=img.device)
    d_x = torch.empty((N, P), dtype=torch.float32, device=img.device)
    d_y = torch.empty_like(d_x)
    d_s = torch.empty_like(d_x) if scale is not None else None
    err = cuda_build.launch(
        _launcher(), img.device, img.data_ptr(), x.data_ptr(), y.data_ptr(),
        s.data_ptr() if s is not None else None, g.data_ptr(),
        acc.data_ptr(), d_x.data_ptr(), d_y.data_ptr(),
        d_s.data_ptr() if d_s is not None else None, N, H, W, C, P,
        img.element_size(), int(tap))
    if err != 0:
        raise RuntimeError(f"dcn_sample_bwd kernel launch failed: CUDA "
                           f"error {err}")
    launches += 2 if tap else 1
    d_img = acc.reshape(N, H, W, C)
    return (d_img if f32_d_img else d_img.to(img.dtype)), d_x, d_y, d_s


def bilinear_sample_pix_bwd(img, x, y, scale, g):
    """The sampler's backward: the plain version for CPU tensors, the
    kernel for CUDA ones."""
    if img.device.type == "cpu":
        _check(img, x, y, scale, g)
        return bilinear_sample_pix_bwd_plain(img, x, y, scale, g)
    return bilinear_sample_pix_bwd_kernel(img, x, y, scale, g)
