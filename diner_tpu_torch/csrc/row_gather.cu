// Row gather, out[p] = table[clamp(idx[p], 0, R-1)] — CUDA C++ for Hopper
// (sm_90a).
//
// Replaces diner_tpu/ops/pallas/gather_pallas.py:_row_gather_kernel
// (launched by pallas_row_gather). That kernel issues one HBM->VMEM DMA per
// row with `depth` copies in flight, and Mosaic restricts it to rows of a
// multiple of 128 lanes. Neither carries over: here a row is just
// row_bytes bytes, whatever the dtype, so the sampler's 20-byte rows
// (C = 5 f32) and the depth map's 4-byte rows (C = 1 f32) work as well as the
// latent's 1 KB (C = 512 bf16) and the pair table's 2 KB (C = 1024 bf16).
//
// Bound: a pure indexed copy with no arithmetic, so bytes. A launch must read
// each index (8 B as the port passes them), each distinct table row it
// touches once, and write P rows. At the eval path's latent corner
// (P = 1,048,576 rows of 1 KB, 491,520-row table) that is about 1.6 GB in
// the worst case, some 0.5 ms at 3.35 TB/s; at the one-stage sampler's map
// gather (P = 16,384,000 rows of 20 B) about 0.49 GB, 0.15 ms.
//
// Design: one thread per vector unit of the output, the unit being the
// widest of 16/8/4/2/1 bytes that divides the row bytes, the row stride and
// both base addresses (chosen by the wrapper and checked here). Neighbouring
// threads write neighbouring units, so stores coalesce; a row's units are
// read by neighbouring threads, so the row is fetched in full sectors. The
// loop is grid-stride over at most 8 blocks of 256 threads per SM; offsets
// are 64-bit, and the unit counter is 32-bit only where the count fits
// (the index-to-row division is then a 32-bit one). Indices are clamped to
// [0, R-1], so no read leaves the table (JAX's x[idx] clamps as well, after
// wrapping negative indices; the port passes none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kBlocksPerSm = 8;

template <typename V, typename I, typename U>
__global__ void row_gather_kernel(const unsigned char* __restrict__ table,
                                  long long n_rows, long long stride_bytes,
                                  const I* __restrict__ idx, U units_per_row,
                                  U n_units, V* __restrict__ out) {
  const U step = (U)gridDim.x * kBlock;
  for (U u = (U)blockIdx.x * kBlock + threadIdx.x; u < n_units; u += step) {
    const U p = u / units_per_row;
    const U j = u - p * units_per_row;
    long long r = (long long)idx[p];
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    out[u] = reinterpret_cast<const V*>(table + r * stride_bytes)[j];
  }
}

template <typename V, typename I>
void launch(const void* table, long long n_rows, long long stride_bytes,
            const void* idx, long long units_per_row, long long n_units,
            void* out, int grid, cudaStream_t stream) {
  const unsigned char* t = static_cast<const unsigned char*>(table);
  const I* ix = static_cast<const I*>(idx);
  V* o = static_cast<V*>(out);
  // a 32-bit counter where u + step cannot wrap
  if (n_units + (long long)grid * kBlock < (1LL << 32)) {
    row_gather_kernel<V, I, uint32_t><<<grid, kBlock, 0, stream>>>(
        t, n_rows, stride_bytes, ix, (uint32_t)units_per_row,
        (uint32_t)n_units, o);
  } else {
    row_gather_kernel<V, I, uint64_t><<<grid, kBlock, 0, stream>>>(
        t, n_rows, stride_bytes, ix, (uint64_t)units_per_row,
        (uint64_t)n_units, o);
  }
}

template <typename V>
void launch_idx(int idx_bytes, const void* table, long long n_rows,
                long long stride_bytes, const void* idx,
                long long units_per_row, long long n_units, void* out,
                int grid, cudaStream_t stream) {
  if (idx_bytes == 8) {
    launch<V, long long>(table, n_rows, stride_bytes, idx, units_per_row,
                         n_units, out, grid, stream);
  } else {
    launch<V, int>(table, n_rows, stride_bytes, idx, units_per_row, n_units,
                   out, grid, stream);
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    count[dev] = 0;
    return 132;
  }
  return count[dev];
}

}  // namespace

// Gathers n_idx rows of row_bytes bytes each, row r of the table starting at
// table + r * stride_bytes, into the contiguous out (n_idx, row_bytes).
// idx holds n_idx indices of idx_bytes (4 or 8) bytes. unit_bytes (16, 8, 4,
// 2 or 1) must divide row_bytes, stride_bytes and both addresses. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int row_gather(const void* table, long long n_rows,
                          long long row_bytes, long long stride_bytes,
                          const void* idx, int idx_bytes, long long n_idx,
                          void* out, int unit_bytes, void* stream) {
  if (n_idx == 0) return 0;
  const unsigned long long align =
      (unsigned long long)row_bytes | (unsigned long long)stride_bytes |
      (unsigned long long)(uintptr_t)table | (unsigned long long)(uintptr_t)out;
  if (n_idx < 0 || n_rows <= 0 || row_bytes <= 0 || stride_bytes < row_bytes ||
      (idx_bytes != 4 && idx_bytes != 8) || unit_bytes <= 0 ||
      unit_bytes > 16 || (unit_bytes & (unit_bytes - 1)) ||
      (align & (unsigned long long)(unit_bytes - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long units_per_row = row_bytes / unit_bytes;
  const long long n_units = n_idx * units_per_row;
  const long long blocks = (n_units + kBlock - 1) / kBlock;
  const long long cap = (long long)sm_count() * kBlocksPerSm;
  const int grid = (int)(blocks < cap ? blocks : cap);
  auto* go = unit_bytes == 16  ? &launch_idx<uint4>
             : unit_bytes == 8 ? &launch_idx<uint2>
             : unit_bytes == 4 ? &launch_idx<unsigned int>
             : unit_bytes == 2 ? &launch_idx<unsigned short>
                               : &launch_idx<unsigned char>;
  go(idx_bytes, table, n_rows, stride_bytes, idx, units_per_row, n_units, out,
     grid, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
