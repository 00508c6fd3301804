"""The top-1 nearest-vertex lookup as a CUDA kernel, and its plain version.

``csrc/knn1.cu`` replaces the JAX package's ``diner_tpu/ops/knn.py:knn1``
(not a Pallas kernel: an MXU matmul over chunked distance tiles, standing
in for pytorch3d's ``knn_points`` with K = 1 in the reference's NOVEL
renderer); its bound and design are in the source. For each scene and
point it returns the index of the vertex with the least

    d² = (−2 · ((px·vx + py·vy) + pz·vz)) + ((vx·vx + vy·vy) + vz·vz),

|p|² dropped, every product and sum rounded on its own, ties to the lower
index and the first NaN distance before every number (``argmin``'s rules).
:func:`knn1_plain` computes that expression with elementwise tensor ops on
(chunk, V) tiles, so the kernel and the plain version choose the same
vertex; ``chunk`` bounds only the plain version's tile, the kernel takes
the whole call in one launch.

The kernel skips the vertex tiles that cannot hold a point's nearest
vertex. :func:`tile_plan` lays the vertices out for it with plain tensor
ops (Morton order, tiles in index order, each tile's box, representatives);
the argmin itself is the kernel's.

:func:`knn1` runs the plain version for CPU tensors and launches the kernel
for CUDA ones, or raises. The index comes from an argmin and passes no
gradient, so there is no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import cuda_build

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]
MAX_SCENES = 65535  # gridDim.y
TILE = 128        # vertices a tile: 206 tiles at FaceScape's 26,317
REP_STRIDE = 32   # a representative every 32 vertices of the Morton order
MORTON_BITS = 10  # per axis: 30-bit codes


@functools.cache
def _launcher():
    fn = cuda_build.load("knn1").knn1
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(points, vertices):
    if points.dim() != 3 or points.shape[-1] != 3 or vertices.dim() != 3 \
            or vertices.shape[-1] != 3 \
            or vertices.shape[0] != points.shape[0]:
        raise ValueError(f"knn1: points {tuple(points.shape)} and vertices "
                         f"{tuple(vertices.shape)}, expected (SB, N, 3) and "
                         "(SB, V, 3)")
    if vertices.shape[1] == 0:
        raise ValueError("knn1: no vertices")
    if points.device != vertices.device:
        raise ValueError(f"knn1: points on {points.device}, vertices on "
                         f"{vertices.device}")


def knn1_plain(points, vertices, chunk: int = 2048):
    """The plain version: (SB, N, 3) points, (SB, V, 3) vertices → (SB, N)
    int32 indices of the nearest vertex, in f32 on (chunk, V) tiles."""
    _check(points, vertices)
    p = points.float()
    v = vertices.float()
    vx, vy, vz = (v[..., k][:, None, :] for k in range(3))  # (SB, 1, V)
    v_sq = (vx * vx + vy * vy) + vz * vz
    SB, N, _ = p.shape
    out = []
    for s in range(0, N, max(int(chunk), 1)):
        c = p[:, s:s + chunk]
        d2 = c[..., 0:1] * vx
        d2 += c[..., 1:2] * vy
        d2 += c[..., 2:3] * vz
        d2 *= -2.0
        d2 += v_sq
        out.append(d2.argmin(-1))
    if not out:
        return torch.zeros((SB, 0), dtype=torch.int32, device=p.device)
    return torch.cat(out, dim=1).to(torch.int32)


def _spread_bits(q):
    """The low ``MORTON_BITS`` bits of int32 ``q`` moved to every third
    bit (the x, y or z lane of a Morton code)."""
    q = (q | (q << 16)) & 0x030000FF
    q = (q | (q << 8)) & 0x0300F00F
    q = (q | (q << 4)) & 0x030C30C3
    return (q | (q << 2)) & 0x09249249


def morton_codes(vertices):
    """(SB, V, 3) f32 → (SB, V) int32: 30-bit Morton codes of the
    coordinates quantised to each scene's box of finite vertices; a vertex
    with a non-finite coordinate gets 2^30, after every finite one. The
    codes only order the vertices: any rounding here moves work, not
    answers."""
    v = vertices
    finite = torch.isfinite(v).all(-1)
    off = ~finite[..., None]
    lo = v.masked_fill(off, float("inf")).amin(1, keepdim=True)
    hi = v.masked_fill(off, -float("inf")).amax(1, keepdim=True)
    lo = torch.nan_to_num(lo, posinf=0.0)
    cells = 1 << MORTON_BITS
    scale = cells / (hi - lo).clamp_min(1e-30)
    q = torch.nan_to_num((v - lo) * scale, nan=0.0)
    q = q.clamp(0, cells - 1).int()
    code = (_spread_bits(q[..., 0]) | (_spread_bits(q[..., 1]) << 1)
            | (_spread_bits(q[..., 2]) << 2))
    return code.masked_fill(~finite, 1 << 30)


def tile_plan(vertices):
    """The kernel's layout of (SB, V, 3) vertices, in plain tensor ops:

    - ``verts`` (SB, V, 4) f32: (x, y, z, |v|²) in tile order (the Morton
      order cut into tiles of ``TILE``, each tile in increasing original
      index), |v|² rounded op by op as :func:`knn1_plain` does;
    - ``vidx`` (SB, V) int32: each one's original index;
    - ``boxes`` (SB, ceil(V / TILE), 8) f32: each tile's lower and upper
      corner, R1 (the largest |x| + |y| + |z|) and m (the largest
      |coordinate|, NaN or inf when one is);
    - ``reps`` (SB, ceil(V / REP_STRIDE), 4) f32: every ``REP_STRIDE``-th
      vertex of the Morton order, from the middle of its stride, as
      ``verts``.
    """
    v = vertices.float()
    SB, V, _ = v.shape
    tile, rep_stride = TILE, REP_STRIDE
    order = torch.argsort(morton_codes(v), dim=1, stable=True)
    T = -(-V // tile)
    pad = T * tile - V  # sentinels V sort last, in the last tile
    perm = torch.nn.functional.pad(order, (0, pad), value=V)
    perm = perm.reshape(SB, T, tile).sort(dim=-1).values.reshape(SB, -1)
    perm = perm[:, :V]

    def rows(index):  # (SB, n) → (SB, n, 4): x, y, z, |v|²
        p = torch.gather(v, 1, index[..., None].expand(-1, -1, 3))
        x, y, z = p.unbind(-1)
        return torch.stack([x, y, z, (x * x + y * y) + z * z], dim=-1)

    verts = rows(perm)
    last = torch.arange(T * tile, device=v.device).clamp_max(V - 1)
    vt = verts[:, last, :3].reshape(SB, T, tile, 3)  # last tile repeats
    a = vt.abs()
    r1 = ((a[..., 0] + a[..., 1]) + a[..., 2]).amax(2)
    boxes = torch.cat([vt.amin(2), vt.amax(2), r1[..., None],
                       a.amax((2, 3))[..., None]], dim=-1)
    mid = torch.arange(rep_stride // 2, V + rep_stride // 2, rep_stride,
                       device=v.device).clamp_max(V - 1)
    reps = rows(order[:, mid])
    return dict(verts=verts.contiguous(), vidx=perm.int().contiguous(),
                boxes=boxes.contiguous(), reps=reps.contiguous())


def _launch(points, vertices, scanned=None):
    """Check, lay out and launch; → (SB, N) int32."""
    global launches
    _check(points, vertices)
    if points.device.type != "cuda":
        raise ValueError(f"knn1 kernel: points on {points.device}, expected "
                         "a CUDA device")
    if points.dtype != torch.float32 or vertices.dtype != torch.float32:
        raise ValueError(f"knn1 kernel: {points.dtype} points and "
                         f"{vertices.dtype} vertices, expected float32")
    SB, N, _ = points.shape
    if SB > MAX_SCENES:
        raise ValueError(f"knn1 kernel: {SB} scenes, at most {MAX_SCENES}")
    points = points.contiguous()
    out = torch.empty((SB, N), dtype=torch.int32, device=points.device)
    if N == 0:
        return out
    plan = tile_plan(vertices)
    err = cuda_build.launch(
        _launcher(), points.device, points.data_ptr(),
        plan["verts"].data_ptr(), plan["vidx"].data_ptr(),
        plan["boxes"].data_ptr(), plan["reps"].data_ptr(), out.data_ptr(),
        scanned.data_ptr() if scanned is not None else None, N,
        vertices.shape[1], TILE, plan["reps"].shape[1], SB)
    if err != 0:
        raise RuntimeError(f"knn1 kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def knn1_kernel(points, vertices):
    """Launch the kernel: (SB, N, 3), (SB, V, 3) f32 CUDA tensors (made
    contiguous) → (SB, N) int32."""
    return _launch(points, vertices)


def knn1_kernel_culled(points, vertices):
    """:func:`knn1_kernel`, and the share of (warp, tile) pairs the warps
    skipped (warps of 32 consecutive points, every tile of the scene)."""
    scanned = torch.zeros(1, dtype=torch.int64, device=points.device)
    out = _launch(points, vertices, scanned)
    SB, N = out.shape
    pairs = SB * -(-N // 32) * -(-vertices.shape[1] // TILE)
    return out, 1.0 - int(scanned) / max(pairs, 1)


def knn1(points, vertices, chunk: int = 2048):
    """Index of the nearest vertex of every point: (SB, N, 3), (SB, V, 3)
    → (SB, N) int32. The kernel for CUDA tensors, the plain version (tiles
    of ``chunk`` points) for CPU ones."""
    if points.device.type == "cpu":
        return knn1_plain(points, vertices, chunk)
    return knn1_kernel(points, vertices)
