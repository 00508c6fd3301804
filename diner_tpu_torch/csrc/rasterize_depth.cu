// Mesh z-buffer (kernel R) — CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's diner_tpu/preprocessing/rasterize.py:24
// rasterize_depth (jitted XLA, no Pallas: pixel blocks × face chunks under
// lax.map / lax.scan), which stands in for the reference's pyrender/EGL
// ground-truth depth of the FaceScape and multiface preprocessing.
//
// What it computes, for each pixel centre p = (x + 0.5, y + 0.5) of an
// H × W map, from the projected vertices uv (V, 2) and camera depths z (V)
// (projected once by ops/rasterize_cuda.py:project, shared with the plain
// version) and the faces (F, 3):
//   d = p − v0, e1 = v1 − v0, e2 = v2 − v0
//   denom = e1.x·e2.y − e1.y·e2.x
//   b1 = (d.x·e2.y − d.y·e2.x) / denom, b2 = (e1.x·d.y − e1.y·d.x) / denom
//   b0 = (1 − b1) − b2
//   covered  ⇔ the face is valid, b0, b1, b2 ≥ 0, and p lies in the face's
//              screen bounding box grown by one pixel
//   depth    = 1 / max((b0/z0 + b1/z1) + b2/z2, 1e-9)
// and writes the least depth over the faces that cover p, 0 where none
// does. A face is valid when z0, z1, z2 > znear and |denom| ≥ 1e-12: the
// JAX function clamps |denom| < 1e-12 to 1e-12 instead, so a collapsed face
// (three equal vertices) has b1 = b2 = 0 at every pixel and covers the
// whole map; the port drops such faces, as pyrender draws no fragment for a
// zero-area triangle. The bounding-box term changes nothing for a face whose
// barycentrics are not dominated by rounding (an inside point lies in the
// box); it makes the binning below exact, so the kernel and the plain
// version (ops/rasterize_cuda.py:rasterize_depth_plain) agree bit for bit.
// Every operation is rounded on its own (__fmul_rn / __fsub_rn / __fadd_rn /
// __fdiv_rn, no contraction into an FMA), in the order above. The least
// depth does not depend on the order the faces are visited in (a covered
// face's depth is finite and > 0), so the lists' order, which the atomics
// below change from run to run, does not change the map.
//
// Bound: bytes. At 2048×1334 on a 50,400-face head mesh the bytes (the
// 10.9 MB map, the 0.9 MB mesh) take 3.5 µs at 3.35 TB/s; the pair tests a
// z-buffer needs, the pixel centres inside each face's grown box, are
// 3.4e6, 0.75 µs at 15 operations each over the 67 TFLOP/s FP32 rate. The
// first design (every 16×16 tile read every face's box, dense in F; kept
// in lab/rasterize_variants.cu) took 1.30 ms there.
//
// Design: faces are binned to 16×16 pixel tiles first, so a tile reads
// only the faces whose grown box meets it. A memset and four launches a
// call:
//   1. rasterize_bin: one record per face (v0, e1, e2, denom, z0..z2,
//      |denom|·2^-100) and its grown box (empty for an invalid face); from
//      the box, the range of pixel centres it can hold and so its range of
//      tiles; a face whose range spans more than kSpan tiles on an axis
//      goes to the "large" list, which every tile reads; any other adds 1
//      to each of its tiles' counters (≤ kSpan² a face; the lanes of a warp
//      on the same tile share one atomic: neighbouring faces share tiles,
//      and the atomics on one counter serialize).
//   2. rasterize_scan: one block's exclusive scan of the tile counters, and
//      the work items: each tile's list cut into slices of kSlice ids.
//   3. rasterize_scatter: each binned face writes its id into the lists of
//      its tiles (an atomic cursor a tile, shared by a warp as above).
//   4. rasterize_tiles: every block first writes zeros over the tiles with
//      no face, 32 at a time; then persistent blocks (a thread per pixel
//      of a tile) take work items from an atomic counter and stage the
//      slice in shared memory; each warp tests the faces' boxes against
//      its own rows (a ballot, one face a lane), queues the (face, pixel)
//      pairs whose pixel centre lies in the box, and evaluates them 32 at
//      a time, keeping each pixel's largest 1/z: the least depth is its
//      one reciprocal, as the rounded 1/x falls as x grows. The slices of
//      a list combine by atomicMax on the map, after the first slice has
//      stored its pixels; the large faces are tested against the tile and
//      compacted (a warp ballot) by the first slice.
// Why slices: a block a tile waits on its longest list, and lists are
// uneven: on a head with no pole (chip_smoke.cube_head_mesh) the longest
// is 3× the mean (218 of 71 ids at 50,400 faces, 3,075 of 912 at
// 1,008,000), and at the poles of chip_smoke.head_mesh 15–24×. With one
// work item a tile, the call took 0.082 / 0.449 ms on the pole-free head
// against the slices' 0.075 / 0.292 (1,008,000 faces: 1.5×), and 0.167 /
// 2.63 against 0.077 / 0.305 on the poled one (H100 80GB HBM3, 700 W;
// lab/rasterize_variants.py, PERF.md §6). Why the queue: it keeps the
// divisions on full warps, where a face's box holds a few of a warp's 32
// pixels.
// The scratch is sized on the host from F alone (kSpan² · F ids), so a
// call reads nothing back and a CUDA graph can capture it; the counters
// are cleared by a memset on the stream. Tile ranges come from the f32 box
// by ceil / floor of (box − 0.5), clamped in float to the map before any
// cast: a pixel centre that the per-pixel box test admits always lies in
// the range (tests/test_torch_kernel_plans.py emulates the plan), boxes of
// ±1e10 included, and a box off the map gets no entry. The per-pair test
// skips the divisions where the sign of a barycentric's numerator already
// rejects the pair (see inv_depth), which changes no result.
// Tile size 16×16 (256 threads) and slices of 128 ids, staged 128 at a
// time: lab/rasterize_variants.py builds copies of this source with
// other constants and times them beside it on an H100 (PERF.md §6). 8×8
// tiles are 1.7× slower at 50,400 faces (1.7× the list ids in 4× the
// tiles) and 32×32 tiles 1.8–2.1× slower at 1,008,000 (2.9× the pair
// tests); slices of 64 are within 5 % at 50,400 faces and 17–22 % slower
// at 1,008,000, slices of 256 10–23 % slower and within 2 %.
// Offsets are 64-bit where they index the map or the records.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kTile = 16;                // pixels per tile side
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kChunk = 128;  // faces staged in shared memory at a time
constexpr int kSlice = 128;  // list ids a work item takes (kChunk's multiple)
constexpr int kSpan = 4;     // tiles a binned face may span on each axis
// tile blocks an SM holds: 2048 threads, at most 32 registers a thread
constexpr int kMinBlocks = 2048 / kThreads;
constexpr int kScanThreads = 1024;
static_assert(kThreads % 32 == 0 && 32 % kTile == 0 && kChunk <= kThreads &&
                  kSlice % kChunk == 0,
              "a warp holds whole rows; a chunk is staged a face a thread");

struct Face {
  float4 a;    // v0.x, v0.y, e1.x, e1.y
  float4 b;    // e2.x, e2.y, denom, z0
  float4 c;    // z1, z2, |denom|·2^-100, unused
};

__device__ __forceinline__ float min3(float a, float b, float c) {
  float m = a < b ? a : b;
  return m < c ? m : c;
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  float m = a > b ? a : b;
  return m > c ? m : c;
}

// The tiles whose pixel centres can lie in the grown box: centre x + 0.5
// ≥ xlo ⇔ x ≥ ceil(xlo − 0.5), and x + 0.5 ≤ xhi ⇔ x ≤ floor(xhi − 0.5).
// Where xlo − 0.5 rounds (|xlo| ≥ 2^23) it rounds to a neighbour of an
// integral xlo, which only widens the range. False when the box misses the
// map (or is the empty box of an invalid face).
__device__ __forceinline__ bool tile_range(float4 bx, int H, int W, int& x0,
                                           int& x1, int& y0, int& y1) {
  const float cx0 = fmaxf(ceilf(__fsub_rn(bx.x, 0.5f)), 0.f);
  const float cx1 = fminf(floorf(__fsub_rn(bx.y, 0.5f)), (float)(W - 1));
  const float cy0 = fmaxf(ceilf(__fsub_rn(bx.z, 0.5f)), 0.f);
  const float cy1 = fminf(floorf(__fsub_rn(bx.w, 0.5f)), (float)(H - 1));
  if (!(cx0 <= cx1 && cy0 <= cy1)) return false;
  x0 = (int)cx0 / kTile;
  x1 = (int)cx1 / kTile;
  y0 = (int)cy0 / kTile;
  y1 = (int)cy1 / kTile;
  return true;
}

__device__ __forceinline__ bool is_large(int x0, int x1, int y0, int y1) {
  return x1 - x0 >= kSpan || y1 - y0 >= kSpan;
}

// Lanes of a warp walk their faces' tiles in step; lanes on the same tile
// in a step share one atomic (consecutive faces of a mesh share tiles).
// → the rank of the lane among them, and the value the atomic returned.
__device__ __forceinline__ int warp_tile_add(int* __restrict__ ctr, int t,
                                             int& rank) {
  const int lane = threadIdx.x % 32;
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  const int leader = __ffs(peers) - 1;
  rank = __popc(peers & ((1u << lane) - 1u));
  int base = 0;
  if (t >= 0 && lane == leader) base = atomicAdd(ctr + t, __popc(peers));
  return __shfl_sync(0xffffffffu, base, leader);
}

__global__ void rasterize_bin(const float* __restrict__ uv,
                              const float* __restrict__ z,
                              const int* __restrict__ faces, int F,
                              float znear, int H, int W, int gx,
                              Face* __restrict__ rec,
                              float4* __restrict__ box,
                              int* __restrict__ counts,
                              int* __restrict__ n_large,
                              int* __restrict__ large) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int x0 = 0, x1 = 0, y0 = 0, y1 = 0, n = 0;  // n: tiles to count
  if (f < F) {
    const int i0 = faces[3LL * f], i1 = faces[3LL * f + 1],
              i2 = faces[3LL * f + 2];
    const float u0 = uv[2LL * i0], v0 = uv[2LL * i0 + 1];
    const float u1 = uv[2LL * i1], v1 = uv[2LL * i1 + 1];
    const float u2 = uv[2LL * i2], v2 = uv[2LL * i2 + 1];
    const float z0 = z[i0], z1 = z[i1], z2 = z[i2];
    const float e1x = __fsub_rn(u1, u0), e1y = __fsub_rn(v1, v0);
    const float e2x = __fsub_rn(u2, u0), e2y = __fsub_rn(v2, v0);
    const float denom = __fsub_rn(__fmul_rn(e1x, e2y), __fmul_rn(e1y, e2x));
    const bool valid = z0 > znear && z1 > znear && z2 > znear &&
                       fabsf(denom) >= 1e-12f;  // false for a NaN denom
    rec[f] = Face{make_float4(u0, v0, e1x, e1y),
                  make_float4(e2x, e2y, denom, z0),
                  make_float4(z1, z2, __fmul_rn(fabsf(denom), 0x1p-100f),
                              0.f)};
    const float inf = __int_as_float(0x7f800000);
    const float4 b = valid ? make_float4(__fsub_rn(min3(u0, u1, u2), 1.f),
                                         __fadd_rn(max3(u0, u1, u2), 1.f),
                                         __fsub_rn(min3(v0, v1, v2), 1.f),
                                         __fadd_rn(max3(v0, v1, v2), 1.f))
                           : make_float4(inf, -inf, inf, -inf);
    box[f] = b;
    if (valid && tile_range(b, H, W, x0, x1, y0, y1)) {
      if (is_large(x0, x1, y0, y1))
        large[atomicAdd(n_large, 1)] = f;
      else
        n = (x1 - x0 + 1) * (y1 - y0 + 1);
    }
  }
  const int nx = x1 - x0 + 1;
  const int steps = __reduce_max_sync(0xffffffffu, n);
  for (int i = 0, rank; i < steps; ++i)
    warp_tile_add(counts, i < n ? (y0 + i / nx) * gx + x0 + i % nx : -1,
                  rank);
}

// The exclusive prefix of v over the block's threads, and the total.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[31];
  return incl - v + (warp ? s_warp[warp - 1] : 0);
}

__device__ __forceinline__ int slices(int n) {
  return n > kSlice ? (n + kSlice - 1) / kSlice : 1;
}

// One block over the tile counters: the lists' offsets (exclusive scan),
// the work items (tile, slice): a tile's list cut into slices of kSlice
// ids; a tile with no list has none, unless there are large faces, which
// the first slice of every tile tests; and their number.
__global__ void __launch_bounds__(kScanThreads)
rasterize_scan(const int* __restrict__ counts,
               const int* __restrict__ n_large, int tiles,
               int* __restrict__ offsets, int* __restrict__ n_work,
               int2* __restrict__ work) {
  __shared__ int s_warp[2][32];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int b = min((int)threadIdx.x * per, tiles), e = min(b + per, tiles);
  const bool any_large = *n_large > 0;
  int ids = 0, items = 0;
  for (int i = b; i < e; ++i) {
    const int n = counts[i];
    ids += n;
    items += n || any_large ? slices(n) : 0;
  }
  int total;
  int at_id = block_scan(ids, s_warp[0], total);
  int at_item = block_scan(items, s_warp[1], total);
  if (threadIdx.x == 0) *n_work = total;
  for (int i = b; i < e; ++i) {
    const int n = counts[i], s = n || any_large ? slices(n) : 0;
    offsets[i] = at_id;
    for (int k = 0; k < s; ++k) work[at_item + k] = make_int2(i, k);
    at_id += n;
    at_item += s;
  }
}

// Each binned face's id into its tiles' lists; afterwards offsets[t] is
// the end of tile t's list.
__global__ void rasterize_scatter(const float4* __restrict__ box, int F,
                                  int H, int W, int gx,
                                  int* __restrict__ offsets,
                                  int* __restrict__ list) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  int x0 = 0, x1 = 0, y0 = 0, y1 = 0, n = 0;
  if (f < F && tile_range(box[f], H, W, x0, x1, y0, y1) &&
      !is_large(x0, x1, y0, y1))
    n = (x1 - x0 + 1) * (y1 - y0 + 1);
  const int nx = x1 - x0 + 1;
  const int steps = __reduce_max_sync(0xffffffffu, n);
  for (int i = 0; i < steps; ++i) {
    int rank;
    const int t = i < n ? (y0 + i / nx) * gx + x0 + i % nx : -1;
    const int base = warp_tile_add(offsets, t, rank);
    if (t >= 0) list[base + rank] = f;
  }
}

// The per-pair test after the box test: the barycentrics and max((b0/z0
// + b1/z1) + b2/z2, 1e-9), whose reciprocal is the pair's depth; 0 where
// the pair is not covered. Both versions' least depth is the reciprocal
// of the largest of these over the faces, since the rounded 1/x falls as
// x grows. Where n1 or n2 has the other sign than denom and |n| ≥
// |denom|·2^-100 (r.c.z), the quotient b1 or b2 is negative and far from
// rounding to ±0, so the pair is not covered and the divisions are
// skipped; most pairs in a face's box end there.
__device__ __forceinline__ float inv_depth(const Face& r, float px,
                                           float py) {
  const float dx = __fsub_rn(px, r.a.x), dy = __fsub_rn(py, r.a.y);
  const float e1x = r.a.z, e1y = r.a.w, e2x = r.b.x, e2y = r.b.y;
  const float denom = r.b.z, tiny = r.c.z;
  const float n1 = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
  const float n2 = __fsub_rn(__fmul_rn(e1x, dy), __fmul_rn(e1y, dx));
  if (denom > 0.f ? n1 <= -tiny || n2 <= -tiny : n1 >= tiny || n2 >= tiny)
    return 0.f;
  const float b1 = __fdiv_rn(n1, denom), b2 = __fdiv_rn(n2, denom);
  const float b0 = __fsub_rn(__fsub_rn(1.f, b1), b2);
  if (!(b0 >= 0.f && b1 >= 0.f && b2 >= 0.f)) return 0.f;
  float inv_z = __fadd_rn(__fdiv_rn(b0, r.b.w), __fdiv_rn(b1, r.c.x));
  inv_z = __fadd_rn(inv_z, __fdiv_rn(b2, r.c.y));
  return inv_z < 1e-9f ? 1e-9f : inv_z;
}

// A warp's queue of pairs (face slot << 5 | lane of the pixel) whose
// pixel centre lies in the face's box, in shared memory, evaluated 32 at
// a time so that the test runs on full warps; each pixel's largest 1/z
// is kept in inv[lane] (the bits of floats > 0 order as ints).
__device__ __forceinline__ void evaluate(const Face* s_rec, const int* q,
                                         int n, int* inv, int x0, int y0) {
  const int lane = threadIdx.x % 32;
  if (lane < n) {
    const int e = q[lane], p = e & 31;
    const int t = (threadIdx.x & ~31) + p;  // the pixel's thread
    const float v = inv_depth(s_rec[e >> 5], (float)(x0 + t % kTile) + 0.5f,
                              (float)(y0 + t / kTile) + 0.5f);
    if (v > 0.f) atomicMax(inv + p, __float_as_int(v));
  }
}

// The m staged faces against a warp's pixels: each lane tests one face's
// box against the band of rows the warp holds (its extreme pixel
// centres); for each face that meets the band (a face whose box misses it
// fails every pixel's box test), each lane tests its pixel centre against
// the box, and the pairs inside are queued.
__device__ __forceinline__ void cover_band(const Face* s_rec,
                                           const float4* s_box, int m,
                                           float4 band, bool in_map,
                                           float px, float py, int* q,
                                           int* inv, int x0, int y0) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;  // pairs queued
  for (int j0 = 0; j0 < m; j0 += 32) {
    bool hit = false;
    if (j0 + lane < m) {
      const float4 b = s_box[j0 + lane];
      hit = b.x <= band.y && b.y >= band.x && b.z <= band.w && b.w >= band.z;
    }
    for (unsigned mask = __ballot_sync(0xffffffffu, hit); mask;
         mask &= mask - 1) {
      const int j = j0 + __ffs(mask) - 1;
      const float4 b = s_box[j];
      const bool in_box =
          in_map && px >= b.x && px <= b.y && py >= b.z && py <= b.w;
      const unsigned inside = __ballot_sync(0xffffffffu, in_box);
      if (in_box) q[n + __popc(inside & below)] = j << 5 | lane;
      n += __popc(inside);
      if (n >= 32) {
        __syncwarp();
        evaluate(s_rec, q, 32, inv, x0, y0);
        n -= 32;
        const int rest = lane < n ? q[32 + lane] : 0;
        __syncwarp();
        if (lane < n) q[lane] = rest;
        __syncwarp();
      }
    }
  }
  __syncwarp();
  evaluate(s_rec, q, n, inv, x0, y0);
  __syncwarp();
}

// First every block writes zeros over the tiles with no face, 32 tiles at
// a time (none such when there are large faces). Then persistent blocks
// take work items in order from an atomic counter. An item evaluates its
// tile's pixels against one slice of the tile's list (and, for the first
// slice, the large faces that meet the tile). A tile of one slice writes
// its pixels' depths. Of a longer list, the first slice stores its
// pixels' largest 1/z and raises the tile's ready flag; the others, taken
// after it, wait for the flag and raise the pixels with atomicMax; the
// last slice to finish (a counter a tile) turns them into depths. With
// counts null (F = 0) every tile writes zeros.
// As many blocks as an SM holds threads (kMinBlocks): its warps wait on
// short chains of shared loads, ballots and divisions, and more of them
// hide more of the wait.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rasterize_tiles(const Face* __restrict__ rec, const float4* __restrict__ box,
                const int* __restrict__ counts, const int* __restrict__ ends,
                const int2* __restrict__ work, const int* __restrict__ n_work,
                int* __restrict__ next, int* __restrict__ done,
                int* __restrict__ ready, const int* __restrict__ list,
                const int* __restrict__ n_large,
                const int* __restrict__ large, int tiles, int gx, int H,
                int W, float* __restrict__ out) {
  __shared__ Face s_rec[kChunk];
  __shared__ float4 s_box[kChunk];
  __shared__ int s_queue[kThreads / 32][64];
  __shared__ int s_inv[kThreads / 32][32];
  __shared__ int s_count, s_item, s_last;
  __shared__ unsigned s_empty;
  const int lane = threadIdx.x % 32;
  int* const q = s_queue[threadIdx.x / 32];
  int* const inv = s_inv[threadIdx.x / 32];
  const int nl = counts ? *n_large : 0;
  if (nl == 0) {
    for (int t0 = blockIdx.x * 32; t0 < tiles; t0 += gridDim.x * 32) {
      __syncthreads();
      if (threadIdx.x < 32) {
        const int t = t0 + lane;
        const unsigned empty =
            __ballot_sync(0xffffffffu, t < tiles && !(counts && counts[t]));
        if (lane == 0) s_empty = empty;
      }
      __syncthreads();
      for (unsigned m = s_empty; m; m &= m - 1) {
        const int t = t0 + __ffs(m) - 1;
        const int x = (t % gx) * kTile + threadIdx.x % kTile;
        const int y = (t / gx) * kTile + threadIdx.x / kTile;
        if (x < W && y < H) out[(long long)y * W + x] = 0.f;
      }
    }
  }
  if (!counts) return;
  const int items = *n_work;
  for (;;) {
    __syncthreads();  // every thread has read the previous item's state
    if (threadIdx.x == 0) s_item = atomicAdd(next, 1);
    __syncthreads();
    if (s_item >= items) return;
    const int2 wk = work[s_item];
    const int t = wk.x, k = wk.y;
    const int n = counts[t], s = slices(n);
    const int x0 = (t % gx) * kTile, y0 = (t / gx) * kTile;
    const int x = x0 + threadIdx.x % kTile, y = y0 + threadIdx.x / kTile;
    const bool in_map = x < W && y < H;
    const long long at = (long long)y * W + x;
    const float px = (float)x + 0.5f, py = (float)y + 0.5f;
    inv[lane] = 0;
    __syncwarp();
    // the extreme pixel centres of the tile and of this warp's rows
    const float tx_lo = (float)x0 + 0.5f;
    const float tx_hi = (float)min(x0 + kTile, W) - 0.5f;
    const float ty_lo = (float)y0 + 0.5f;
    const float ty_hi = (float)min(y0 + kTile, H) - 0.5f;
    const int wy = y0 + threadIdx.x / 32 * (32 / kTile);
    const float4 band = make_float4(tx_lo, tx_hi, (float)wy + 0.5f,
                                    (float)min(wy + 32 / kTile, H) - 0.5f);

    // this item's slice of the tile's list, kChunk ids at a time
    const int c1 = min(n, (k + 1) * kSlice);
    for (int c0 = k * kSlice; c0 < c1; c0 += kChunk) {
      const int m = min(kChunk, c1 - c0);
      __syncthreads();  // every warp is done with the previous chunk
      if (threadIdx.x < m) {
        const int f = list[ends[t] - n + c0 + threadIdx.x];
        s_rec[threadIdx.x] = rec[f];
        s_box[threadIdx.x] = box[f];
      }
      __syncthreads();
      cover_band(s_rec, s_box, m, band, in_map, px, py, q, inv, x0, y0);
    }

    // the large faces (first slice only), each tested against the tile
    for (int c0 = 0; k == 0 && c0 < nl; c0 += kChunk) {
      __syncthreads();
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
      bool hit = false;
      float4 bx;
      int f = 0;
      if (threadIdx.x < kChunk && c0 + threadIdx.x < nl) {
        f = large[c0 + threadIdx.x];
        bx = box[f];
        hit = bx.x <= tx_hi && bx.y >= tx_lo && bx.z <= ty_hi &&
              bx.w >= ty_lo;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      int base = 0;
      if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (hit) {
        const int slot = base + __popc(ballot & ((1u << lane) - 1u));
        s_rec[slot] = rec[f];
        s_box[slot] = bx;
      }
      __syncthreads();
      cover_band(s_rec, s_box, s_count, band, in_map, px, py, q, inv, x0,
                 y0);
    }

    const float best = __int_as_float(inv[lane]);  // the largest 1/z, or 0
    if (s == 1) {
      if (in_map) out[at] = best > 0.f ? __fdiv_rn(1.f, best) : 0.f;
      continue;
    }
    if (k == 0) {
      if (in_map) out[at] = best;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicExch(ready + t, 1);
    } else {
      if (threadIdx.x == 0)
        while (*reinterpret_cast<volatile int*>(ready + t) == 0) {
        }
      __syncthreads();
      __threadfence();
      if (in_map)
        atomicMax(reinterpret_cast<int*>(out) + at, __float_as_int(best));
      __threadfence();
      __syncthreads();
    }
    if (threadIdx.x == 0) s_last = atomicAdd(done + t, 1) == s - 1;
    __syncthreads();
    if (s_last && in_map) {
      const float v = __ldcg(out + at);
      out[at] = v > 0.f ? __fdiv_rn(1.f, v) : 0.f;
    }
  }
}

}  // namespace

// uv (V, 2) f32, z (V) f32, faces (F, 3) int32 (indices in [0, V)), all
// contiguous; rec (F × 48 B) and box (F × 16 B) scratch; bins: int32
// scratch (ops/rasterize_cuda.py:bin_layout) for T = ⌈H/kTile⌉·⌈W/kTile⌉
// tiles: the work items (int2, T + ⌈kSpan²·F / kSlice⌉ at most), the
// counters, the large count, the work counter, the tiles' done counters
// and ready flags (these cleared by the memset), the offsets, the item
// count, the large list (F) and the tiles' lists (kSpan²·F ids); the
// base is 8-byte aligned; out (H, W) f32; sms: the
// card's multiprocessors (the persistent grid is kMinBlocks blocks
// each). The caller keeps H, W ≤ 2^24 and the scratch under 2^31
// entries. Returns the CUDA error of the memset and launches (0 if none).
extern "C" int rasterize_depth(const float* uv, const float* z,
                               const int* faces, int F, float znear, int H,
                               int W, void* rec, void* box, int* bins,
                               float* out, int sms, cudaStream_t stream) {
  if (F < 0 || H < 1 || W < 1 || H > (1 << 24) || W > (1 << 24) || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long gx = (W + kTile - 1) / kTile, gy = (H + kTile - 1) / kTile;
  const long long tiles = gx * gy;
  const long long cap = (long long)kSpan * kSpan * F;
  const long long items = tiles + (cap + kSlice - 1) / kSlice;
  if (4 * tiles + 3 + 2 * items + F + cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Face* r = static_cast<Face*>(rec);
  float4* b = static_cast<float4*>(box);
  int2* work = reinterpret_cast<int2*>(bins);  // 8-byte aligned first
  int* counts = bins + 2 * items;
  int* n_large = counts + tiles;
  int* next = n_large + 1;
  int* done = next + 1;
  int* ready = done + tiles;
  int* offsets = ready + tiles;
  int* n_work = offsets + tiles;
  int* large = n_work + 1;
  int* list = large + F;
  const long long grid = std::min<long long>(
      (long long)sms * kMinBlocks, F > 0 ? items : tiles);
  cudaError_t err;
  if (F > 0) {
    err = cudaMemsetAsync(counts, 0, (3 * tiles + 2) * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (F + 255) / 256;
    rasterize_bin<<<blocks, 256, 0, stream>>>(uv, z, faces, F, znear, H, W,
                                              (int)gx, r, b, counts, n_large,
                                              large);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rasterize_scan<<<1, kScanThreads, 0, stream>>>(counts, n_large,
                                                   (int)tiles, offsets,
                                                   n_work, work);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rasterize_scatter<<<blocks, 256, 0, stream>>>(b, F, H, W, (int)gx,
                                                  offsets, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const bool any = F > 0;
  rasterize_tiles<<<(unsigned)grid, kThreads, 0, stream>>>(
      r, b, any ? counts : nullptr, offsets, work, n_work, next, done, ready,
      list, n_large, large, (int)tiles, (int)gx, H, W, out);
  return (int)cudaGetLastError();
}
