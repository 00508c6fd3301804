// Row gather, out[p] = table[clamp(idx[p], 0, R-1)] — CUDA C++ for Hopper
// (sm_90a).
//
// Replaces diner_tpu/ops/pallas/gather_pallas.py:_row_gather_kernel
// (launched by pallas_row_gather). That kernel issues one HBM->VMEM DMA per
// row with `depth` copies in flight and takes only rows of a multiple of 128
// lanes. Here a row is just row_bytes bytes, whatever the dtype: the
// sampler's 20 B rows (C = 5 f32), the depth map's 4 B (C = 1 f32), the
// latent's 1 KB (C = 512 bf16) and the pair table's 2 KB (C = 1024 bf16).
//
// Bound: an indexed copy with no arithmetic, so bytes: each index (8 B as
// the port passes them), each distinct table row touched, read once, and P
// rows written. At the path's shapes on the H100 (3.35 TB/s):
//   latent corner  P = 1,048,576 x 1 KB: 1.07 GB written, 8.4 MB of indices;
//                  ~0.44 GB of distinct rows at uniform random indices
//                  (0.456 ms), ~22 MB at one real chunk's (0.330 ms). A
//                  random row misses the 50 MB L2, so ~1 GB is read in fact.
//   pair rows      P = 1,048,576 x 2 KB: 2.1 GB written (0.908 ms random).
//   sampler map    P = 16,384,000 x 20 B: 0.33 GB written, 0.13 GB of
//                  indices, a 26 MB table that stays in L2 (0.145 ms).
//   depth lookup   P = 1,048,576 x 4 B: 12.6 MB in all (0.0046 ms).
// Random 1-2 KB rows are read from HBM (the L2 holds a tenth of the
// latent), so there reads and writes together set the pace; at the path's
// own indices the touched rows fit in L2 and the output's writes do; the
// 4-20 B rows are bound by L2 sector requests and latency more than bytes.
// The design keeps enough loads in flight, loads each index once per row,
// coalesces every table read and store, and keeps the output from evicting
// the touched rows from L2.
//
// Design: three regimes, picked by the wrapper (ops/gather_cuda.py:plan)
// from the row bytes, the row stride and the two base addresses, and
// checked here. The unit is the widest of 16/8/4/2/1 bytes dividing all
// four.
//   narrow (row <= 32 B in units >= 4 B; read in 4 B units, their count U a
//     template parameter): a warp takes two batches of 32 rows, once. Lane i loads
//     the index of row i of each batch (coalesced, once per row); then the
//     lanes read the batch's 32 U units in order, unit f from row f / U at the
//     offset broadcast by __shfl_sync, so neighbouring lanes read
//     neighbouring bytes of a row and write neighbouring bytes of the
//     output. All of a lane's 2 U loads are issued before the first is used.
//   wide (row >= 256 B in 16 B units): a warp takes two rows of up to
//     512 B, or one wider row, once (a one-shot grid that covers P, so the
//     rows in flight are a narrow window of the output). Lanes load the row
//     indices once, the row offsets are broadcast with __shfl_sync, and each
//     lane has two (rows up to 1 KB) to four (2 KB) 16 B loads in flight.
//   units (everything else: 33-255 B rows, 1-2 B units, wide rows at an odd
//     offset): one thread per unit of the output in a grid-stride loop over
//     an occupancy-sized grid, the row found by a multiply-shift division by
//     the units per row (no divide instruction).
// Table reads go through the read-only path (__ldg); the narrow and wide
// regimes store with st.global.cs (evict first), so an output of up to 2 GB
// does not push the touched rows out of L2. Each choice was measured against
// its alternatives by lab/row_gather_variants.py (PERF.md): bypassing
// L1 (ld.global.nc.L1::no_allocate) made the 20 B rows 1.7x and windowed
// 1 KB rows 1.2x slower; a lane per row that reads and writes its own 20 B
// row made them 1.9x slower; grid-stride warps over an occupancy-sized grid
// were 3-4 % slower for wide rows and no faster for narrow ones; plain
// stores were 3-9 % slower than streaming ones where the touched rows fit in
// L2; L2 prefetch hints (L2::128B, L2::256B) and 2 to 16 loads per lane
// moved the wide rows by under 1 %. At uniformly random 1-2 KB rows every
// one-shot variant, index_select's own vectorized gather included, runs
// within 1 % of the same HBM rate.
// Byte offsets are 64-bit; the row and unit counters are 32-bit, so a call
// larger than kMaxChunk rows (or units) launches in chunks. Indices are
// clamped to [0, R-1], so no read leaves the table (JAX's x[idx] clamps as
// well, after wrapping negative indices; the port passes none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowMaxRowBytes = 32;
constexpr int kNarrowBatches = 2;  // of 32 rows per warp
constexpr int kNarrowRowsPerWarp = 32 * kNarrowBatches;
constexpr int kWideMinRowBytes = 256;
constexpr int kWideLoadsPerLane = 2;  // per row step, at least one row
// rows (or units) per launch: thread, warp and row numbers stay in 32 bits
constexpr long long kMaxChunk = 1LL << 26;

// regimes, as ops/gather_cuda.py numbers them
constexpr int kNarrow = 0, kUnits = 1, kWide = 2;

__host__ __device__ constexpr int wide_rows_per_warp(int units_per_lane) {
  return kWideLoadsPerLane / units_per_lane > 0
             ? kWideLoadsPerLane / units_per_lane
             : 1;
}

template <typename I>
__device__ __forceinline__ long long clamp_row(I i, long long n_rows) {
  const long long r = (long long)i;
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// narrow: rows of kUnits 4 B units; a warp takes kNarrowBatches batches of
// 32 rows, lane i loading the index of row i of each batch and the lanes
// then reading consecutive units of the batch (flat unit f is unit f % U of
// row f / U, whose offset comes from lane f / U by __shfl_sync)
template <int kUnits, typename I>
__global__ void __launch_bounds__(kBlock) row_gather_narrow(
    const unsigned char* __restrict__ table, long long n_rows,
    long long stride_bytes, const I* __restrict__ idx, int n_idx,
    unsigned int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int base =
      ((blockIdx.x * kBlock + threadIdx.x) >> 5) * kNarrowRowsPerWarp;
  if (base >= n_idx) return;  // the whole warp
  long long src[kNarrowBatches];
#pragma unroll
  for (int b = 0; b < kNarrowBatches; ++b) {
    const int p = base + 32 * b + lane;
    src[b] = p < n_idx ? clamp_row(__ldg(idx + p), n_rows) * stride_bytes : 0;
  }
  unsigned int v[kNarrowBatches][kUnits];
#pragma unroll
  for (int b = 0; b < kNarrowBatches; ++b) {
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int f = lane + 32 * m;
      const int row = f / kUnits;
      const long long s =
          kUnits == 1 ? src[b] : __shfl_sync(kFull, src[b], row);
      if (base + 32 * b + row < n_idx) {
        v[b][m] = __ldg(reinterpret_cast<const unsigned int*>(table + s) +
                        (f - row * kUnits));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kNarrowBatches; ++b) {
#pragma unroll
    for (int m = 0; m < kUnits; ++m) {
      const int f = lane + 32 * m;
      if (base + 32 * b + f / kUnits < n_idx) {
        __stcs(out + (long long)(base + 32 * b) * kUnits + f, v[b][m]);
      }
    }
  }
}

// wide: 16 B units, kUnitsPerLane of a row's units per lane and step; a
// warp takes kRows consecutive rows
template <int kUnitsPerLane, typename I>
__global__ void __launch_bounds__(kBlock) row_gather_wide(
    const unsigned char* __restrict__ table, long long n_rows,
    long long stride_bytes, const I* __restrict__ idx, int n_idx, int units,
    uint4* __restrict__ out) {
  constexpr int kRows = wide_rows_per_warp(kUnitsPerLane);
  const int lane = threadIdx.x & 31;
  const int base = ((blockIdx.x * kBlock + threadIdx.x) >> 5) * kRows;
  if (base >= n_idx) return;  // the whole warp
  const int n = min(kRows, n_idx - base);
  const long long my_src =
      lane < n ? clamp_row(__ldg(idx + base + lane), n_rows) * stride_bytes
               : 0;
  const uint4* src[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    src[j] = reinterpret_cast<const uint4*>(table +
                                            __shfl_sync(kFull, my_src, j));
  }
  for (int u0 = lane; u0 < units; u0 += 32 * kUnitsPerLane) {
    uint4 v[kRows][kUnitsPerLane];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int q = 0; q < kUnitsPerLane; ++q) {
        const int u = u0 + 32 * q;
        if (j < n && u < units) v[j][q] = __ldg(src[j] + u);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int q = 0; q < kUnitsPerLane; ++q) {
        const int u = u0 + 32 * q;
        if (j < n && u < units) {
          __stcs(out + (long long)(base + j) * units + u, v[j][q]);
        }
      }
    }
  }
}

// q = n / d for n < 2^31 as (umulhi(n, m) + n) >> s, m and s from the host
struct Divider {
  unsigned int m, s;
};

Divider make_divider(unsigned int d) {
  unsigned int s = 0;
  while ((1ULL << s) < d) ++s;
  const uint64_t m = ((1ULL << 32) * ((1ULL << s) - d)) / d + 1;
  return {(unsigned int)m, s};
}

__device__ __forceinline__ unsigned int divide(unsigned int n, Divider d) {
  return (__umulhi(n, d.m) + n) >> d.s;
}

// units: one thread per unit V of the output
template <typename V, typename I>
__global__ void __launch_bounds__(kBlock) row_gather_units(
    const unsigned char* __restrict__ table, long long n_rows,
    long long stride_bytes, const I* __restrict__ idx, unsigned int units,
    Divider by_units, unsigned int n_units, V* __restrict__ out) {
  const unsigned int step = gridDim.x * kBlock;
  for (unsigned int u = blockIdx.x * kBlock + threadIdx.x; u < n_units;
       u += step) {
    const unsigned int p = divide(u, by_units);
    const unsigned int j = u - p * units;
    const long long r = clamp_row(__ldg(idx + p), n_rows);
    out[u] = __ldg(reinterpret_cast<const V*>(table + r * stride_bytes) + j);
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

// blocks for `needed` blocks of grid-stride work: at most as many as fit on
// the card at once (occupancy asked once per kernel)
template <auto Kernel>
int grid_for(long long needed) {
  static int per_sm = 0;
  if (per_sm == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &per_sm, Kernel, kBlock, 0) != cudaSuccess ||
                      per_sm < 1)) {
    per_sm = 1;
  }
  const long long cap = (long long)per_sm * sm_count();
  return (int)(needed < cap ? needed : cap);
}

struct Args {
  const unsigned char* table;
  long long n_rows, row_bytes, stride_bytes;
  const void* idx;
  long long n_idx;
  unsigned char* out;
  int unit_bytes;
  cudaStream_t stream;
};

template <int kUnits, typename I>
void launch_narrow(const Args& a) {
  constexpr int kRowsPerBlock = kWarps * kNarrowRowsPerWarp;
  for (long long p0 = 0; p0 < a.n_idx; p0 += kMaxChunk) {
    const int n = (int)(a.n_idx - p0 < kMaxChunk ? a.n_idx - p0 : kMaxChunk);
    row_gather_narrow<kUnits, I>
        <<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kBlock, 0, a.stream>>>(
            a.table, a.n_rows, a.stride_bytes,
            static_cast<const I*>(a.idx) + p0, n,
            reinterpret_cast<unsigned int*>(a.out + p0 * a.row_bytes));
  }
}

template <int kUnitsPerLane, typename I>
void launch_wide(const Args& a) {
  constexpr int kRowsPerBlock = kWarps * wide_rows_per_warp(kUnitsPerLane);
  const int units = (int)(a.row_bytes / 16);
  for (long long p0 = 0; p0 < a.n_idx; p0 += kMaxChunk) {
    const int n = (int)(a.n_idx - p0 < kMaxChunk ? a.n_idx - p0 : kMaxChunk);
    row_gather_wide<kUnitsPerLane, I>
        <<<(n + kRowsPerBlock - 1) / kRowsPerBlock, kBlock, 0, a.stream>>>(
            a.table, a.n_rows, a.stride_bytes,
            static_cast<const I*>(a.idx) + p0, n, units,
            reinterpret_cast<uint4*>(a.out + p0 * a.row_bytes));
  }
}

template <typename V, typename I>
void launch_units(const Args& a) {
  const long long units = a.row_bytes / a.unit_bytes;
  const long long rows_per_chunk = kMaxChunk / units;
  const Divider by_units = make_divider((unsigned int)units);
  for (long long p0 = 0; p0 < a.n_idx; p0 += rows_per_chunk) {
    const long long n =
        a.n_idx - p0 < rows_per_chunk ? a.n_idx - p0 : rows_per_chunk;
    const int grid =
        grid_for<&row_gather_units<V, I>>((n * units + kBlock - 1) / kBlock);
    row_gather_units<V, I><<<grid, kBlock, 0, a.stream>>>(
        a.table, a.n_rows, a.stride_bytes, static_cast<const I*>(a.idx) + p0,
        (unsigned int)units, by_units, (unsigned int)(n * units),
        reinterpret_cast<V*>(a.out + p0 * a.row_bytes));
  }
}

template <typename I>
void launch(int regime, const Args& a) {
  const int u = a.unit_bytes;
  if (regime == kNarrow) {
    switch (a.row_bytes / 4) {
      case 1: launch_narrow<1, I>(a); break;
      case 2: launch_narrow<2, I>(a); break;
      case 3: launch_narrow<3, I>(a); break;
      case 4: launch_narrow<4, I>(a); break;
      case 5: launch_narrow<5, I>(a); break;
      case 6: launch_narrow<6, I>(a); break;
      case 7: launch_narrow<7, I>(a); break;
      default: launch_narrow<8, I>(a); break;
    }
  } else if (regime == kWide) {
    const long long units = a.row_bytes / 16;
    if (units <= 32) launch_wide<1, I>(a);
    else if (units <= 64) launch_wide<2, I>(a);
    else launch_wide<4, I>(a);
  } else {
    if (u == 16) launch_units<uint4, I>(a);
    else if (u == 8) launch_units<uint2, I>(a);
    else if (u == 4) launch_units<unsigned int, I>(a);
    else if (u == 2) launch_units<unsigned short, I>(a);
    else launch_units<unsigned char, I>(a);
  }
}

}  // namespace

// Gathers n_idx rows of row_bytes bytes each, row r of the table starting at
// table + r * stride_bytes, into the contiguous out (n_idx, row_bytes).
// idx holds n_idx indices of idx_bytes (4 or 8) bytes. unit_bytes (16, 8, 4,
// 2 or 1) must divide row_bytes, stride_bytes and both addresses; regime 0
// (narrow) takes rows of at most 32 B in units of at least 4 B (and reads
// them in 4 B units), regime 2 (wide) rows of at least 256 B in 16 B units,
// regime 1 (units) any. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int row_gather(const void* table, long long n_rows,
                          long long row_bytes, long long stride_bytes,
                          const void* idx, int idx_bytes, long long n_idx,
                          void* out, int regime, int unit_bytes,
                          void* stream) {
  if (n_idx == 0) return 0;
  const unsigned long long align =
      (unsigned long long)row_bytes | (unsigned long long)stride_bytes |
      (unsigned long long)(uintptr_t)table | (unsigned long long)(uintptr_t)out;
  const bool narrow_ok = row_bytes <= kNarrowMaxRowBytes && unit_bytes >= 4;
  const bool wide_ok = row_bytes >= kWideMinRowBytes && unit_bytes == 16;
  if (n_idx < 0 || n_rows <= 0 || row_bytes <= 0 || stride_bytes < row_bytes ||
      (idx_bytes != 4 && idx_bytes != 8) || unit_bytes <= 0 ||
      unit_bytes > 16 || (unit_bytes & (unit_bytes - 1)) ||
      (align & (unsigned long long)(unit_bytes - 1)) ||
      row_bytes / unit_bytes > kMaxChunk ||
      !((regime == kNarrow && narrow_ok) || (regime == kWide && wide_ok) ||
        regime == kUnits)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const unsigned char*>(table), n_rows, row_bytes,
               stride_bytes, idx, n_idx, static_cast<unsigned char*>(out),
               unit_bytes, (cudaStream_t)stream};
  if (idx_bytes == 8) {
    launch<long long>(regime, a);
  } else {
    launch<int>(regime, a);
  }
  return (int)cudaGetLastError();
}
