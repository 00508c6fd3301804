"""The mesh z-buffer (kernel R) as a CUDA kernel, and its plain version.

``csrc/rasterize_depth.cu`` replaces the JAX package's
``diner_tpu/preprocessing/rasterize.py:rasterize_depth`` (jitted XLA, no
Pallas kernel: pixel blocks × face chunks under ``lax.map`` /
``lax.scan``); its bound and design are in the source: faces are binned to
``TILE``×``TILE`` pixel tiles (a count, a scan, a scatter of face ids),
then persistent blocks take a tile's list in slices of ``SLICE`` ids and
read only those and the few faces that span more than ``SPAN`` tiles on
an axis. Its scratch is sized on the host from F and the map alone
(:func:`bin_layout`), so a call reads nothing back and can be captured in
a CUDA graph. Both versions start
from the same projection (:func:`project`: the vertices in camera space,
then ``uv = xy / z · (fx, fy) + (cx, cy)``, with plain tensor ops) and
compute, at each pixel centre, the least perspective-correct depth
``1 / max(b0/z0 + b1/z1 + b2/z2, 1e-9)`` over the valid faces whose screen
barycentrics are all ≥ 0 and whose bounding box, grown by one pixel, holds
the centre; 0 where no face does. Every product, sum and quotient is
rounded on its own in the same order, so the kernel and
:func:`rasterize_depth_plain` return the same map bit for bit.

A face is valid when its three vertices lie beyond ``znear`` and
``|denom| ≥ 1e-12`` (twice its signed screen area). The JAX function
clamps a smaller ``denom`` to 1e-12 instead, which makes a collapsed face
cover every pixel of the map; the port drops it, as pyrender draws nothing
for a zero-area triangle.

:func:`rasterize` runs the plain version for CPU tensors and launches the
kernel for CUDA ones, or raises. A depth map passes no gradient, so there
is no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import cuda_build

# kernel launches since the count was last set to 0 (read by chip_smoke.py):
# a call with F > 0 launches the bin, scan, scatter and tile kernels, one
# with F = 0 the tile kernel alone (it writes zeros)
launches = 0
LAUNCHES_PER_CALL = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _F, _I, _I, _P, _P, _P, _P, _I, _P]
TILE = 16         # csrc/rasterize_depth.cu's kTile: pixels per tile side
SPAN = 4          # its kSpan: tiles a binned face may span on each axis
SLICE = 128       # its kSlice: list ids a work item takes
MAX_SIDE = 1 << 24  # H and W (exact in f32, as the kernel's clamps need)
INT_LIMIT = 2 ** 31 - 1  # the kernel's int32 ids, offsets and tile index
DENOM_MIN = 1e-12
INV_Z_MIN = 1e-9


@functools.cache
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _launcher():
    fn = cuda_build.load("rasterize_depth").rasterize_depth
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def bin_layout(F: int, H: int, W: int) -> dict:
    """The kernel's int32 scratch, from F and the map alone: at most
    ``items`` work items (int2: a tile's list cut into slices of ``SLICE``
    ids, at ``0``), then at ``counts`` the ``tiles`` counters, the
    large-face count, the work counter, ``tiles`` done counters and ready
    flags (these cleared by a memset), ``tiles`` offsets, the item count,
    a large list of F ids and the tiles' lists, ``capacity`` = SPAN²·F ids
    (a binned face spans at most SPAN × SPAN tiles)."""
    gx, gy = -(-W // TILE), -(-H // TILE)
    tiles = gx * gy
    capacity = SPAN * SPAN * F
    items = tiles + -(-capacity // SLICE)
    return dict(gx=gx, gy=gy, tiles=tiles, capacity=capacity, items=items,
                counts=2 * items,
                ints=2 * items + 4 * tiles + 3 + F + capacity)


def project(vertices, K, Rt):
    """World vertices (V, 3) → screen ``uv`` (V, 2) and camera depth ``z``
    (V,), f32, with elementwise ops in the JAX function's order
    (``rasterize.py:38-43``): ``v_cam = v @ R.T + t`` as
    ``((x·r0 + y·r1) + z·r2) + t``, ``uv = xy / where(z == 0, 1e-9, z) ·
    (fx, fy) + (cx, cy)``. ``Rt`` is (3, 4) or (4, 4) world→camera."""
    v = vertices.float()
    K = K.float()
    Rt = Rt.float()
    cam = [((v[:, 0] * Rt[i, 0] + v[:, 1] * Rt[i, 1]) + v[:, 2] * Rt[i, 2])
           + Rt[i, 3] for i in range(3)]
    z = cam[2]
    zs = torch.where(z == 0, torch.full_like(z, 1e-9), z)
    u = cam[0] / zs * K[0, 0] + K[0, 2]
    w = cam[1] / zs * K[1, 1] + K[1, 2]
    return torch.stack([u, w], dim=-1), z


def _check(uv, z, faces, H, W):
    if uv.dim() != 2 or uv.shape[-1] != 2 or z.shape != uv.shape[:1] \
            or faces.dim() != 2 or faces.shape[-1] != 3:
        raise ValueError(f"rasterize: uv {tuple(uv.shape)}, z "
                         f"{tuple(z.shape)}, faces {tuple(faces.shape)}; "
                         "expected (V, 2), (V,), (F, 3)")
    if H < 1 or W < 1:
        raise ValueError(f"rasterize: a {H}×{W} map")
    if not (uv.device == z.device == faces.device):
        raise ValueError(f"rasterize: uv on {uv.device}, z on {z.device}, "
                         f"faces on {faces.device}")


def face_terms(uv, z, faces, znear: float):
    """Per face: v0 (u0, v0), e1, e2, denom, (z0, z1, z2), the validity
    mask and the bounding box grown by one pixel (xlo, xhi, ylo, yhi)."""
    f = faces.long()
    tu, tv, tz = uv[f, 0], uv[f, 1], z[f]  # (F, 3) each
    e1x = tu[:, 1] - tu[:, 0]
    e1y = tv[:, 1] - tv[:, 0]
    e2x = tu[:, 2] - tu[:, 0]
    e2y = tv[:, 2] - tv[:, 0]
    denom = e1x * e2y - e1y * e2x
    valid = (tz > znear).all(-1) & (denom.abs() >= DENOM_MIN)
    return dict(
        u0=tu[:, 0], v0=tv[:, 0], e1x=e1x, e1y=e1y, e2x=e2x, e2y=e2y,
        denom=denom, z=tz, valid=valid,
        xlo=torch.minimum(torch.minimum(tu[:, 0], tu[:, 1]), tu[:, 2]) - 1.0,
        xhi=torch.maximum(torch.maximum(tu[:, 0], tu[:, 1]), tu[:, 2]) + 1.0,
        ylo=torch.minimum(torch.minimum(tv[:, 0], tv[:, 1]), tv[:, 2]) - 1.0,
        yhi=torch.maximum(torch.maximum(tv[:, 0], tv[:, 1]), tv[:, 2]) + 1.0)


def cover(px, py, t):
    """The per-pair test: pixel centres ``px``, ``py`` (P, 1) against the
    faces of :func:`face_terms` ``t`` (n,) → (covered (P, n), inv_z (P,
    n): ``max((b0/z0 + b1/z1) + b2/z2, 1e-9)``, whose reciprocal is the
    depth where covered), every operation in the kernel's order."""
    dx = px - t["u0"][None]
    dy = py - t["v0"][None]
    e1x, e1y = t["e1x"][None], t["e1y"][None]
    e2x, e2y = t["e2x"][None], t["e2y"][None]
    denom = t["denom"][None]
    b1 = (dx * e2y - dy * e2x) / denom
    b2 = (e1x * dy - e1y * dx) / denom
    b0 = (1.0 - b1) - b2
    inside = (t["valid"][None] & (px >= t["xlo"][None])
              & (px <= t["xhi"][None]) & (py >= t["ylo"][None])
              & (py <= t["yhi"][None])
              & (b0 >= 0) & (b1 >= 0) & (b2 >= 0))
    tz = t["z"]
    inv_z = (b0 / tz[None, :, 0] + b1 / tz[None, :, 1]) + b2 / tz[None, :, 2]
    return inside, torch.where(inv_z < INV_Z_MIN,
                               torch.full_like(inv_z, INV_Z_MIN), inv_z)


def rasterize_depth_plain(uv, z, faces, H: int, W: int, znear: float = 1e-4,
                          pixel_block: int = 4096, face_chunk: int = 4096):
    """The plain version: the (H, W) f32 z-buffer of the projected mesh,
    with elementwise tensor ops on (pixel_block, face_chunk) tiles. A pixel
    block (a run of whole or part rows) takes only the valid faces whose
    grown box meets its rows, by the same f32 compares as the per-pixel
    box test, so the map is that of every face."""
    _check(uv, z, faces, H, W)
    uv = uv.float()
    z = z.float()
    dev = uv.device
    F = faces.shape[0]
    out = torch.full((H * W,), float("inf"), device=dev)
    if F == 0:
        return torch.zeros((H, W), device=dev)
    t = face_terms(uv, z, faces, znear)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev)
                            + 0.5,
                            torch.arange(W, dtype=torch.float32, device=dev)
                            + 0.5, indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pb, fc = max(int(pixel_block), 1), max(int(face_chunk), 1)
    for p0 in range(0, H * W, pb):
        p1 = min(p0 + pb, H * W)
        px, py = xs[p0:p1, None], ys[p0:p1, None]
        best = out[p0:p1]
        # the faces whose box meets the block's first to last row
        keep = t["valid"] & (t["ylo"] <= ys[p1 - 1]) & (t["yhi"] >= ys[p0])
        tb = {k: v[keep] for k, v in t.items()}
        for f0 in range(0, tb["u0"].shape[0], fc):
            inside, inv_z = cover(px, py, {k: v[f0:f0 + fc]
                                           for k, v in tb.items()})
            depth = torch.where(inside, 1.0 / inv_z,
                                torch.full_like(inv_z, float("inf")))
            best = torch.minimum(best, depth.amin(dim=1))
        out[p0:p1] = best
    out = torch.where(torch.isinf(out), torch.zeros_like(out), out)
    return out.reshape(H, W)


def _launch(uv, z, faces, H: int, W: int, znear: float):
    """Check, allocate and launch → (out, the int32 bin scratch)."""
    global launches
    _check(uv, z, faces, H, W)
    if uv.device.type != "cuda":
        raise ValueError(f"rasterize kernel: uv on {uv.device}, expected a "
                         "CUDA device")
    if uv.dtype != torch.float32 or z.dtype != torch.float32:
        raise ValueError(f"rasterize kernel: {uv.dtype} uv and {z.dtype} z, "
                         "expected float32")
    if H > MAX_SIDE or W > MAX_SIDE:
        raise ValueError(f"rasterize kernel: a {H}×{W} map, at most "
                         f"{MAX_SIDE} a side")
    F = faces.shape[0]
    layout = bin_layout(F, H, W)
    if layout["tiles"] > INT_LIMIT or layout["ints"] > INT_LIMIT:
        raise ValueError(f"rasterize kernel: {F} faces on a {H}×{W} map "
                         f"need {layout['ints']} int32 bin entries, more "
                         f"than {INT_LIMIT}")
    uv = uv.contiguous()
    z = z.contiguous()
    faces = faces.to(torch.int32).contiguous()
    dev = uv.device
    rec = torch.empty((max(F, 1), 12), dtype=torch.float32, device=dev)
    box = torch.empty((max(F, 1), 4), dtype=torch.float32, device=dev)
    bins = torch.empty(max(layout["ints"], 1), dtype=torch.int32, device=dev)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    err = cuda_build.launch(_launcher(), dev, uv.data_ptr(), z.data_ptr(),
                            faces.data_ptr(), F, float(znear), H, W,
                            rec.data_ptr(), box.data_ptr(), bins.data_ptr(),
                            out.data_ptr(), _multiprocessors(dev.index))
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error "
                           f"{err}")
    launches += LAUNCHES_PER_CALL if F > 0 else 1
    return out, bins


def rasterize_depth_kernel(uv, z, faces, H: int, W: int,
                           znear: float = 1e-4):
    """Launch the kernel: uv (V, 2), z (V,) f32 and faces (F, 3) integer
    CUDA tensors (indices in [0, V), not checked here) → (H, W) f32."""
    return _launch(uv, z, faces, H, W, znear)[0]


def rasterize_depth_kernel_bins(uv, z, faces, H: int, W: int,
                                znear: float = 1e-4):
    """The kernel's map and what its bins held, read back after the call:
    (out, {"counts": (gy, gx) faces listed a tile, "entries": their sum,
    "large": faces on the large list})."""
    out, bins = _launch(uv, z, faces, H, W, znear)
    layout = bin_layout(faces.shape[0], H, W)
    if faces.shape[0] == 0:
        counts = torch.zeros((layout["gy"], layout["gx"]), dtype=torch.int32)
        return out, dict(counts=counts, entries=0, large=0)
    c, n = layout["counts"], layout["tiles"]
    counts = bins[c:c + n].reshape(layout["gy"], layout["gx"]).cpu()
    return out, dict(counts=counts, entries=int(counts.long().sum()),
                     large=int(bins[c + n]))


def rasterize(uv, z, faces, H: int, W: int, znear: float = 1e-4,
              pixel_block: int = 4096, face_chunk: int = 4096):
    """The z-buffer of the projected mesh: the kernel for CUDA tensors, the
    plain version (``pixel_block`` × ``face_chunk`` tiles) for CPU ones."""
    if uv.device.type == "cpu":
        return rasterize_depth_plain(uv, z, faces, H, W, znear, pixel_block,
                                     face_chunk)
    return rasterize_depth_kernel(uv, z, faces, H, W, znear)
