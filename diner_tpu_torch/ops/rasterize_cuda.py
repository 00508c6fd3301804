"""The mesh z-buffer (kernel R) as a CUDA kernel, and its plain version.

``csrc/rasterize_depth.cu`` replaces the JAX package's
``diner_tpu/preprocessing/rasterize.py:rasterize_depth`` (jitted XLA, no
Pallas kernel: pixel blocks × face chunks under ``lax.map`` /
``lax.scan``); its bound and design are in the source. Both versions start
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
# a call launches the setup kernel (when F > 0) and the raster kernel
launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _F, _I, _I, _P, _P, _P, _P]
MAX_TILE_ROWS = 65535 * 16  # gridDim.y tiles of 16 rows
DENOM_MIN = 1e-12
INV_Z_MIN = 1e-9


@functools.cache
def _launcher():
    fn = cuda_build.load("rasterize_depth").rasterize_depth
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    box = (torch.minimum(torch.minimum(tu[:, 0], tu[:, 1]), tu[:, 2]) - 1.0,
           torch.maximum(torch.maximum(tu[:, 0], tu[:, 1]), tu[:, 2]) + 1.0,
           torch.minimum(torch.minimum(tv[:, 0], tv[:, 1]), tv[:, 2]) - 1.0,
           torch.maximum(torch.maximum(tv[:, 0], tv[:, 1]), tv[:, 2]) + 1.0)
    return dict(u0=tu[:, 0], v0=tv[:, 0], e1x=e1x, e1y=e1y, e2x=e2x,
                e2y=e2y, denom=denom, z=tz, valid=valid, box=box)


def rasterize_depth_plain(uv, z, faces, H: int, W: int, znear: float = 1e-4,
                          pixel_block: int = 4096, face_chunk: int = 4096):
    """The plain version: the (H, W) f32 z-buffer of the projected mesh,
    with elementwise tensor ops on (pixel_block, face_chunk) tiles."""
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
        px, py = xs[p0:p0 + pb, None], ys[p0:p0 + pb, None]
        best = out[p0:p0 + pb]
        for f0 in range(0, F, fc):
            s = slice(f0, f0 + fc)
            dx = px - t["u0"][None, s]
            dy = py - t["v0"][None, s]
            e1x, e1y = t["e1x"][None, s], t["e1y"][None, s]
            e2x, e2y = t["e2x"][None, s], t["e2y"][None, s]
            denom = t["denom"][None, s]
            b1 = (dx * e2y - dy * e2x) / denom
            b2 = (e1x * dy - e1y * dx) / denom
            b0 = (1.0 - b1) - b2
            xlo, xhi, ylo, yhi = (b[None, s] for b in t["box"])
            inside = (t["valid"][None, s] & (px >= xlo) & (px <= xhi)
                      & (py >= ylo) & (py <= yhi)
                      & (b0 >= 0) & (b1 >= 0) & (b2 >= 0))
            tz = t["z"][s]
            inv_z = (b0 / tz[None, :, 0] + b1 / tz[None, :, 1]) \
                + b2 / tz[None, :, 2]
            inv_z = torch.where(inv_z < INV_Z_MIN,
                                torch.full_like(inv_z, INV_Z_MIN), inv_z)
            depth = torch.where(inside, 1.0 / inv_z,
                                torch.full_like(inv_z, float("inf")))
            best = torch.minimum(best, depth.amin(dim=1))
        out[p0:p0 + pb] = best
    out = torch.where(torch.isinf(out), torch.zeros_like(out), out)
    return out.reshape(H, W)


def rasterize_depth_kernel(uv, z, faces, H: int, W: int,
                           znear: float = 1e-4):
    """Launch the kernel: uv (V, 2), z (V,) f32 and faces (F, 3) integer
    CUDA tensors (indices in [0, V), not checked here) → (H, W) f32."""
    global launches
    _check(uv, z, faces, H, W)
    if uv.device.type != "cuda":
        raise ValueError(f"rasterize kernel: uv on {uv.device}, expected a "
                         "CUDA device")
    if uv.dtype != torch.float32 or z.dtype != torch.float32:
        raise ValueError(f"rasterize kernel: {uv.dtype} uv and {z.dtype} z, "
                         "expected float32")
    if H > MAX_TILE_ROWS:
        raise ValueError(f"rasterize kernel: {H} rows, at most "
                         f"{MAX_TILE_ROWS}")
    F = faces.shape[0]
    if F >= 2 ** 31:
        raise ValueError(f"rasterize kernel: {F} faces, fewer than 2^31")
    uv = uv.contiguous()
    z = z.contiguous()
    faces = faces.to(torch.int32).contiguous()
    rec = torch.empty((max(F, 1), 12), dtype=torch.float32, device=uv.device)
    box = torch.empty((max(F, 1), 4), dtype=torch.float32, device=uv.device)
    out = torch.empty((H, W), dtype=torch.float32, device=uv.device)
    err = cuda_build.launch(_launcher(), uv.device, uv.data_ptr(),
                            z.data_ptr(), faces.data_ptr(), F, float(znear),
                            H, W, rec.data_ptr(), box.data_ptr(),
                            out.data_ptr())
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error "
                           f"{err}")
    launches += 2 if F > 0 else 1
    return out


def rasterize(uv, z, faces, H: int, W: int, znear: float = 1e-4,
              pixel_block: int = 4096, face_chunk: int = 4096):
    """The z-buffer of the projected mesh: the kernel for CUDA tensors, the
    plain version (``pixel_block`` × ``face_chunk`` tiles) for CPU ones."""
    if uv.device.type == "cpu":
        return rasterize_depth_plain(uv, z, faces, H, W, znear, pixel_block,
                                     face_chunk)
    return rasterize_depth_kernel(uv, z, faces, H, W, znear)
