// Design variants of kernel C (diner_tpu_torch/csrc/row_gather.cu), for
// choosing its regimes by measurement; not part of the package. Driven by
// lab/row_gather_variants.py, which times each against index_select.
//   wide rows (16 B units): wide_persistent (a warp per 32-row batch,
//     grid-stride over an occupancy-sized grid), wide_oneshot (a warp per
//     kLoads / kUPL rows, once), wide_blockrow (a block per row, as
//     index_select's vectorized gather);
//   narrow rows (4 B units): narrow_lane_row (a lane per row, its units
//     read and written by that lane), narrow_coop (lanes on consecutive units of
//     32-row batches, units a runtime value), narrow_fixed (the same with the
//     units a template parameter), units_gs (a thread per unit, grid-stride:
//     the design of the kernel's first version);
//   loads: nc = 0 __ldg, 1 ld.global.nc.L1::no_allocate, 2/3 with an
//     L2::256B / L2::128B prefetch hint; stores: cs = 1 st.global.cs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int load_nc(const unsigned int* p) {
  unsigned int v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 load_pf(const uint4* p, int kind) {
  uint4 v;
  if (kind == 2)
    asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else
    asm("ld.global.nc.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int load_pf(const unsigned int* p, int kind) { return __ldg(p); }
template <typename V> __device__ __forceinline__ V load_v(const V* p, int nc) {
  return nc == 1 ? load_nc(p) : (nc >= 2 ? load_pf(p, nc) : __ldg(p));
}
template <typename V> __device__ __forceinline__ void store_v(V* p, V v, int cs) {
  if (cs) __stcs(p, v); else *p = v;
}
__device__ __forceinline__ long long clampr(long long r, long long n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}
struct Divider { unsigned int m, s; };
Divider make_divider(unsigned int d) {
  unsigned int s = 0;
  while ((1ULL << s) < d) ++s;
  const uint64_t m = ((1ULL << 32) * ((1ULL << s) - d)) / d + 1;
  return {(unsigned int)m, s};
}
__device__ __forceinline__ unsigned int divide(unsigned int n, Divider d) {
  return (__umulhi(n, d.m) + n) >> d.s;
}

// ---- wide, 16 B units
// persistent: warp takes 32-row batches grid-stride, kRows rows per step
template <int kUPL>
__global__ void wide_persistent(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx, int units,
    uint4* __restrict__ out, int nc, int cs) {
  constexpr int kRows = 8 / kUPL;
  const int lane = threadIdx.x & 31;
  const int step = ((gridDim.x * kBlock) >> 5) * 32;
  int base = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * 32;
  long long next = base + lane < n_idx ? __ldg(idx + base + lane) : 0;
  for (; base < n_idx; base += step) {
    const long long my = clampr(next, n_rows) * stride;
    if (base + step + lane < n_idx) next = __ldg(idx + base + step + lane);
    const int n = min(32, n_idx - base);
    for (int j0 = 0; j0 < n; j0 += kRows) {
      const uint4* src[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        src[j] = reinterpret_cast<const uint4*>(table + __shfl_sync(kFull, my, (j0 + j) & 31));
      for (int u0 = lane; u0 < units; u0 += 32 * kUPL) {
        uint4 v[kRows][kUPL];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int q = 0; q < kUPL; ++q)
            if (j0 + j < n && u0 + 32 * q < units) v[j][q] = load_v(src[j] + u0 + 32 * q, nc);
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int q = 0; q < kUPL; ++q)
            if (j0 + j < n && u0 + 32 * q < units)
              store_v(out + (long long)(base + j0 + j) * units + u0 + 32 * q, v[j][q], cs);
      }
    }
  }
}

// one-shot: each warp takes kRows consecutive rows once (grid covers P)
template <int kUPL, int kLoads>
__global__ void wide_oneshot(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx, int units,
    uint4* __restrict__ out, int nc, int cs) {
  constexpr int kRows = kLoads / kUPL > 0 ? kLoads / kUPL : 1;
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * kRows;
  if (base >= n_idx) return;
  const int n = min(kRows, n_idx - base);
  const long long my = lane < n ? clampr(__ldg(idx + base + lane), n_rows) * stride : 0;
  const uint4* src[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    src[j] = reinterpret_cast<const uint4*>(table + __shfl_sync(kFull, my, j));
  for (int u0 = lane; u0 < units; u0 += 32 * kUPL) {
    uint4 v[kRows][kUPL];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int q = 0; q < kUPL; ++q)
        if (j < n && u0 + 32 * q < units) v[j][q] = load_v(src[j] + u0 + 32 * q, nc);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
#pragma unroll
      for (int q = 0; q < kUPL; ++q)
        if (j < n && u0 + 32 * q < units)
          store_v(out + (long long)(base + j) * units + u0 + 32 * q, v[j][q], cs);
  }
}

// block per row (index_select's shape): units/threads
__global__ void wide_blockrow(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx, int units,
    uint4* __restrict__ out, int nc, int cs) {
  const long long r = clampr(__ldg(idx + blockIdx.x), n_rows);
  const uint4* src = reinterpret_cast<const uint4*>(table + r * stride);
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    store_v(out + (long long)blockIdx.x * units + u, load_v(src + u, nc), cs);
}

// ---- narrow: cooperative, lanes take consecutive units of 32-row batches
template <int kBatches, int kMaxU>
__global__ void narrow_coop(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx, int units, Divider by_units,
    unsigned int* __restrict__ out, int nc, int cs, int persistent) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 * kBatches;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int step = persistent ? ((gridDim.x * kBlock) >> 5) * per_warp : n_idx;
  for (int base = warp * per_warp; base < n_idx; base += step) {
    long long off[kBatches];
#pragma unroll
    for (int b = 0; b < kBatches; ++b) {
      const int p = base + 32 * b + lane;
      off[b] = p < n_idx ? clampr(__ldg(idx + p), n_rows) * stride : 0;
    }
    unsigned int v[kBatches][kMaxU];
#pragma unroll
    for (int b = 0; b < kBatches; ++b)
#pragma unroll
      for (int m = 0; m < kMaxU; ++m) {
        const int f = lane + 32 * m;
        const int row = (int)divide((unsigned)f, by_units);
        const int u = f - row * units;
        const long long o = __shfl_sync(kFull, off[b], row & 31);
        if (m < units && base + 32 * b + row < n_idx)
          v[b][m] = load_v(reinterpret_cast<const unsigned int*>(table + o) + u, nc);
      }
#pragma unroll
    for (int b = 0; b < kBatches; ++b)
#pragma unroll
      for (int m = 0; m < kMaxU; ++m) {
        const int f = lane + 32 * m;
        const int row = (int)divide((unsigned)f, by_units);
        if (m < units && base + 32 * b + row < n_idx)
          store_v(out + (long long)(base + 32 * b) * units + f, v[b][m], cs);
      }
  }
}

template <int kBatches, int U>
__global__ void narrow_fixed(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx,
    unsigned int* __restrict__ out, int cs, int persistent) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 * kBatches;
  const int warp = (blockIdx.x * kBlock + threadIdx.x) >> 5;
  const int step = persistent ? ((gridDim.x * kBlock) >> 5) * per_warp : n_idx;
  for (int base = warp * per_warp; base < n_idx; base += step) {
    long long off[kBatches];
#pragma unroll
    for (int b = 0; b < kBatches; ++b) {
      const int p = base + 32 * b + lane;
      off[b] = p < n_idx ? clampr(__ldg(idx + p), n_rows) * stride : 0;
    }
    unsigned int v[kBatches][U];
#pragma unroll
    for (int b = 0; b < kBatches; ++b)
#pragma unroll
      for (int m = 0; m < U; ++m) {
        const int f = lane + 32 * m;
        const int row = f / U;
        const long long o = U == 1 ? off[b] : __shfl_sync(kFull, off[b], row);
        if (base + 32 * b + row < n_idx)
          v[b][m] = __ldg(reinterpret_cast<const unsigned int*>(table + o) + (f - row * U));
      }
#pragma unroll
    for (int b = 0; b < kBatches; ++b)
#pragma unroll
      for (int m = 0; m < U; ++m) {
        const int f = lane + 32 * m;
        if (base + 32 * b + f / U < n_idx)
          store_v(out + (long long)(base + 32 * b) * U + f, v[b][m], cs);
      }
  }
}

// the parent's design: a thread per unit, grid-stride
__global__ void units_gs(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, unsigned units, Divider by_units,
    unsigned n_units, unsigned int* __restrict__ out) {
  const unsigned step = gridDim.x * kBlock;
  for (unsigned u = blockIdx.x * kBlock + threadIdx.x; u < n_units; u += step) {
    const unsigned p = divide(u, by_units);
    const long long r = clampr(__ldg(idx + p), n_rows);
    out[u] = __ldg(reinterpret_cast<const unsigned int*>(table + r * stride) + (u - p * units));
  }
}

// a lane per row (four rows per lane, rows lane + 32 j of a 128-row batch),
// the lane loading all of its row's units and storing them itself
template <int kMaxU>
__global__ void narrow_lane_row(const unsigned char* __restrict__ table, long long n_rows,
    long long stride, const long long* __restrict__ idx, int n_idx, int units,
    unsigned int* __restrict__ out, int nc, int cs) {
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * 128;
  if (base >= n_idx) return;
  long long off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = base + lane + 32 * j;
    off[j] = p < n_idx ? clampr(__ldg(idx + p), n_rows) * stride : 0;
  }
  unsigned int v[4][kMaxU];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u)
      if (u < units && base + lane + 32 * j < n_idx)
        v[j][u] = load_v(reinterpret_cast<const unsigned int*>(table + off[j]) + u, nc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u)
      if (u < units && base + lane + 32 * j < n_idx)
        store_v(out + (long long)(base + lane + 32 * j) * units + u, v[j][u], cs);
}

template <auto K>
int occ(int smem) {
  int n = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, kBlock, smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n * sms;
}
}  // namespace

// variant: 0 wide persistent; 1 wide one-shot (kb = loads per lane: 2, 4,
// 8, 16; at least one row per warp); 2 wide block per row; 10 / 11 narrow_coop persistent / one-shot and
// 20 / 21 narrow_fixed one-shot / persistent (kb = 32-row batches per warp;
// narrow_fixed has U = 1 and 5 only); 29 units_gs; 30 narrow_lane_row.
// Int64 indices.
extern "C" int lab(int variant, const void* table, long long n_rows, long long row_bytes,
                   long long stride, const void* idx, long long n_idx, void* out, int nc,
                   int cs, int kb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* t = (const unsigned char*)table;
  const long long* ix = (const long long*)idx;
  const int n = (int)n_idx;
  if (variant < 10) {
    const int units = (int)(row_bytes / 16);
    uint4* o = (uint4*)out;
#define PERSIST(UPL)                                                          \
  wide_persistent<UPL><<<min((n + 255) / 256, occ<&wide_persistent<UPL>>(0)), \
                         kBlock, 0, st>>>(t, n_rows, stride, ix, n, units, o, nc, cs)
#define ONESHOT(UPL, LD)                                                     \
  {                                                                          \
    constexpr int rows = LD / UPL > 0 ? LD / UPL : 1;                        \
    wide_oneshot<UPL, LD><<<(n + 8 * rows - 1) / (8 * rows), kBlock, 0, st>>>( \
        t, n_rows, stride, ix, n, units, o, nc, cs);                         \
  }
#define BYLD(UPL) \
  { if (kb == 2) ONESHOT(UPL, 2) else if (kb == 4) ONESHOT(UPL, 4) else if (kb == 16) ONESHOT(UPL, 16) else ONESHOT(UPL, 8) }
    if (variant == 2) {
      const int threads = units < 256 ? units : 256;
      wide_blockrow<<<n, threads, 0, st>>>(t, n_rows, stride, ix, n, units, o, nc, cs);
    } else if (variant == 0) {
      if (units <= 32) PERSIST(1); else if (units <= 64) PERSIST(2); else PERSIST(4);
    } else {
      if (units <= 32) BYLD(1) else if (units <= 64) BYLD(2) else BYLD(4)
    }
  } else {
    const int units = (int)(row_bytes / 4);
    const Divider d = make_divider(units);
    unsigned int* o = (unsigned int*)out;
#define COOP(KB)                                                                 \
  {                                                                              \
    const int per_block = 8 * 32 * KB;                                           \
    int grid = (n + per_block - 1) / per_block;                                  \
    if (persistent) grid = min(grid, occ<&narrow_coop<KB, 8>>(0));              \
    narrow_coop<KB, 8><<<grid, kBlock, 0, st>>>(t, n_rows, stride, ix, n, units, \
                                                d, o, nc, cs, persistent);      \
  }
#define FIXED(KB, U)                                                            \
  {                                                                             \
    const int per_block = 8 * 32 * KB;                                          \
    int grid = (n + per_block - 1) / per_block;                                 \
    if (persistent) grid = min(grid, occ<&narrow_fixed<KB, U>>(0));            \
    narrow_fixed<KB, U><<<grid, kBlock, 0, st>>>(t, n_rows, stride, ix, n, o, cs, \
                                                 persistent);                  \
  }
    const int persistent = variant == 10 || variant == 21;
    if (variant == 30) {
      narrow_lane_row<8><<<(n + 1023) / 1024, kBlock, 0, st>>>(t, n_rows, stride, ix, n,
                                                              units, o, nc, cs);
    } else if (variant == 29) {
      units_gs<<<min((n * units + 255) / 256, occ<&units_gs>(0)), kBlock, 0, st>>>(
          t, n_rows, stride, ix, units, d, n * units, o);
    } else if (variant >= 20) {
      if (units != 1 && units != 5) return (int)cudaErrorInvalidValue;
      if (units == 1) { if (kb == 1) FIXED(1, 1) else if (kb == 2) FIXED(2, 1) else FIXED(4, 1) }
      else { if (kb == 1) FIXED(1, 5) else if (kb == 2) FIXED(2, 5) else FIXED(4, 5) }
    } else if (kb == 1) COOP(1) else if (kb == 2) COOP(2) else if (kb == 4) COOP(4) else COOP(8)
  }
  return (int)cudaGetLastError();
}
