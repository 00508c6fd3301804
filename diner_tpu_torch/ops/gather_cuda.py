"""Kernel C — the row gather ``out[p] = table[idx[p]]`` as a CUDA kernel.

``csrc/row_gather.cu`` replaces
``diner_tpu/ops/pallas/gather_pallas.py:_row_gather_kernel`` (launched by
``pallas_row_gather``); its bound and design are in the source. :func:`row_gather` has
the signature of ``pallas_row_gather`` without the TPU tuning arguments and
no 128-lane restriction: any row width, any dtype, int32 or int64 indices.
It runs under every flat row gather of the port: the latent's four corners
and the depth lookup (``ops/grid_sample.py``), the sampler's packed map
(``ops/sampling.py``) and the pair table's two row fetches. :func:`plan`
picks the kernel's regime (narrow, wide or unit-per-thread) and unit width.

For a CPU table it runs the plain version, :func:`row_gather_plain`; for a
CUDA table it launches kernel C or raises. The autograd backward is the
plain ``index_add_`` in the table's dtype, which is what autograd of
``index_select`` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diner_tpu_torch.ops import cuda_build

# kernel C launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = [_P, _L, _L, _L, _P, _I, _L, _P, _I, _I, _P]
INDEX_DTYPES = (torch.int32, torch.int64)
# the regimes of csrc/row_gather.cu, by the number its launcher takes
REGIMES = {"narrow": 0, "units": 1, "wide": 2}
NARROW_MAX_ROW_BYTES = 32
WIDE_MIN_ROW_BYTES = 256


@functools.cache
def _launcher():
    fn = cuda_build.load("row_gather").row_gather
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def row_gather_plain(table, idx):
    """The plain version: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx)


def unit_bytes(*sizes) -> int:
    """The widest of 16/8/4/2/1 bytes dividing every size and address."""
    width = 16
    while width > 1 and any(s % width for s in sizes):
        width //= 2
    return width


def plan(row_bytes: int, stride_bytes: int, table_addr: int,
         out_addr: int) -> tuple[str, int]:
    """Kernel C's (regime, unit bytes) for rows of ``row_bytes`` at
    ``stride_bytes`` from ``table_addr`` into ``out_addr``: "narrow" (lanes
    on consecutive 4 B units of 32-row batches) for rows of at most 32 B
    whose unit is at least 4 B, read in 4 B units; "wide" (a warp on a few
    rows, 16 B per lane and load) for rows of at least 256 B in 16 B units;
    else "units" (a thread per unit)."""
    unit = unit_bytes(row_bytes, stride_bytes, table_addr, out_addr)
    if row_bytes <= NARROW_MAX_ROW_BYTES and unit >= 4:
        return "narrow", 4
    if row_bytes >= WIDE_MIN_ROW_BYTES and unit == 16:
        return "wide", unit
    return "units", unit


def _check(table, idx):
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"row gather: table {tuple(table.shape)} and idx "
                         f"{tuple(idx.shape)}, expected (R, C) and (P,)")
    if idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"row gather: idx is {idx.dtype}, expected int32 "
                         "or int64")
    if table.is_complex() or table.dtype == torch.bool:
        raise ValueError(f"row gather: table dtype {table.dtype} not taken")
    if table.device != idx.device:
        raise ValueError(f"row gather: table on {table.device}, idx on "
                         f"{idx.device}")
    R, C = table.shape
    if (C > 1 and table.stride(1) != 1) or (R > 1 and table.stride(0) < C):
        raise ValueError(f"row gather: table {tuple(table.shape)} with "
                         f"strides {table.stride()}: its last dimension must "
                         "be contiguous and its rows apart (no copy is made)")
    if table.shape[0] == 0 and idx.numel() > 0:
        raise ValueError("row gather: indices into an empty table")


def _launch(table, idx):
    """Kernel C on checked inputs; raises unless the table is on a CUDA
    device."""
    global launches
    if table.device.type != "cuda":
        raise ValueError(f"row gather kernel: table is on {table.device}, "
                         "expected a CUDA device")
    R, C = table.shape
    P = idx.shape[0]
    idx = idx.contiguous()
    out = torch.empty((P, C), dtype=table.dtype, device=table.device)
    if P == 0 or C == 0:
        return out
    size = table.element_size()
    row_bytes = C * size
    stride_bytes = table.stride(0) * size if R > 1 else row_bytes
    regime, unit = plan(row_bytes, stride_bytes, table.data_ptr(),
                        out.data_ptr())
    err = cuda_build.launch(
        _launcher(), table.device, table.data_ptr(), R, row_bytes,
        stride_bytes, idx.data_ptr(), idx.element_size(), P, out.data_ptr(),
        REGIMES[regime], unit)
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def row_gather_kernel(table, idx):
    """Launch kernel C (no autograd): (R, C) table, (P,) int32/int64 indices
    → (P, C) contiguous. Indices are clamped to [0, R − 1] (the plain
    version raises on them instead). The table's rows may be strided; its
    last dimension must be contiguous."""
    _check(table, idx)
    return _launch(table, idx)


class _RowGather(torch.autograd.Function):
    """Forward: kernel C (CUDA) or the plain version (CPU). Backward: the
    plain ``index_add_`` into a zero table of the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        if table.device.type == "cpu":
            return row_gather_plain(table, idx)
        return _launch(table, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        d_table = g.new_zeros(ctx.table_shape)
        return d_table.index_add_(0, idx, g), None


def row_gather(table, idx):
    """``table[idx]`` for a (R, C) table and (P,) int32 or int64 indices →
    (P, C), differentiable with respect to the table."""
    _check(table, idx)
    return _RowGather.apply(table, idx)
