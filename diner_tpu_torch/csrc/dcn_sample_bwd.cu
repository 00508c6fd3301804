// Backward of the DCN sampler (bilinear sampling at pixel positions, zeros
// outside, an optional per-point scale folded into the corner weights) —
// CUDA C++ for Hopper (sm_90a).
//
// Replaces diner_tpu/mvs/dcn.py:_bsp_bwd (the custom VJP of
// _bilinear_sample_pix, with _bsp_bwd_rest). That backward is XLA, not
// Pallas: it pairs the two x-adjacent corners of each point into one 2C-wide
// row of parity canvases because the TPU's scatter ran at a tenth of its
// gather rate. Here the canvas is summed on chip, tile by tile; the function
// is the same.
//
// What it computes, for each point p of (N, P) and each corner k of its 4:
//   acc[idx_k(p), c] += wq_k(p) · g[p, c]            (f32)
//   dw_k(p)  = Σ_c g[p, c] · img[idx_k(p), c]        (f32)
//   d_x(p)   = Σ_k ±dwb_k · (1 − wy1 | wy1),  d_y likewise with wx1,
//   d_scale  = Σ_k wbase_k · dw_k,  dwb_k = dw_k · scale (0 off the image),
// with the corner indices, the validity mask and the weights redone in f32
// exactly as the forward (mvs/dcn.py:bilinear_sample_pix) computes them, and
// wq_k the forward's weight rounded to the image dtype (what the forward
// multiplied by). A corner off the image adds nothing (the plain version adds
// g·0 at its clamped index). The wrapper casts the f32 canvas to the image
// dtype once (ops/dcn_cuda.py).
//
// Bound: bytes. g read once (N·P·C), each distinct image row that a valid
// corner touches read once, x, y, scale read and d_x, d_y, d_scale written
// once, d_img written once. At the stage-3 tap of the 512×640 training step
// (N = 4, P = 327,680, C = 32 f32): g 168 MB, the touched rows ≈ 168 MB,
// d_img 168 MB, the six (N, P) vectors 31 MB: ≈ 0.53 GB, 0.16 ms at
// 3.35 TB/s. The arithmetic (4 multiply-adds and 4 adds a corner and channel)
// is far below the f32 rate.
//
// Two designs, chosen by shape (the wrapper passes `tiled`):
//
// The tap layout (P = H·W, point p at pixel p, C ≤ kMaxTileC): a DCN tap's
// points are its pixel grid plus small learned offsets, so nearly every
// corner lands within a few pixels of its point's own pixel. A block owns a
// kTileH × kTileW tile of the canvas and of the points, in phases:
//   0. it stages its own points' rows of g in shared memory with cp.async
//      and x, y, scale of its region (the tile grown by a ring of kRing
//      pixels);
//   1-3. it lists, by tile pixel, the region's corners that fall on the
//      tile: a counting sort with integer shared-memory atomics, each
//      pixel's list then put in order so that the sums below do not depend
//      on the atomics' order; the rows of g of the ring points that have
//      such a corner are staged too (up to kRingRows);
//   4. four lanes take a pixel, VEC channels a lane at a time: they read
//      the pixel's image row, sum wq·g over its list in registers and store
//      the pixel's canvas row once (no zeroing pass, no float atomics), and
//      take the dot products of the tile's own points with that row;
//   5. four lanes take an own point: the dot products of its corners off
//      the tile (from their image rows), then d_x, d_y, d_scale.
// A corner whose point lies beyond the ring of the tile that holds it is a
// spill: a second launch (dcn_sample_bwd_spill, a thread per point) adds it
// with global atomics after the tiles are written. With the taps' N(0, 1.5)
// pixel offsets and kRing = 4 that is under 0.1 % of the corners
// (ops/dcn_cuda.py:spilled_corners counts it). A first design summed the
// canvas in shared memory with f32 atomics, which sm_90a compiles to
// compare-and-swap loops (ATOMS.CAST.SPIN): 0.55 ms at the stage-3 tap;
// this one takes ≈ 0.42 ms there, 2.7× its bound. Its phase stamps
// (lab/dcn_bwd_variants.py) put half of a block's ≈ 31 µs in phase 4, and
// taking any one part out of it moved the wait into the next phase: the
// blocks wait on their reads, made a pixel or a point at a time, with
// three 73 KB blocks on each SM.
//
// Any other layout (P ≠ H·W: positions not on the pixel grid, or wider rows
// than a tile holds): the first design, a warp per point in a grid-stride
// loop. No caller in the package makes such a call (mvs/dcn.py passes
// P = H·W with C = 32); it serves the shapes the function admits beyond the
// taps, and lab/dcn_bwd_variants.py times it beside the tap design. Its units are (corner, group of VEC channels): lanes take units in
// order, so at C = 32 with VEC = 4 the four corners' 8 groups fill the 32
// lanes and one point is one pass. A lane loads its group of g and of the
// corner's image row, adds the weighted g into the canvas (zeroed by the
// wrapper) with one float4 atomic (sm_90) or VEC scalar ones, and keeps a
// partial dot product per corner; four butterfly sums over the warp give
// dw_0..3, and lane 0 writes d_x, d_y, d_scale.
//
// VEC = 4 needs C % 4 == 0 (rows then 16 B / 8 B aligned) and 16 B aligned
// bases; otherwise VEC = 1. Every kernel's name holds "dcn_sample_bwd": the
// profiles of chip_smoke.py add the port's kernels up by name.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

// With -DDCN_MARKS (lab/dcn_bwd_variants.py builds it so), thread 0 of each
// tile block stamps the global timer at the start and at the end of each
// phase into dcn_marks, which dcn_marks_read copies to the host; otherwise
// DCN_MARK is nothing.
#ifdef DCN_MARKS
__device__ unsigned long long dcn_marks[1 << 16][8];
#define DCN_MARK(i)                                                        \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      dcn_marks[(blockIdx.y * gridDim.x + blockIdx.x) & 0xffff][i] = t_;   \
    }                                                                      \
  } while (0)
extern "C" int dcn_marks_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, dcn_marks, sizeof(dcn_marks));
}
#else
#define DCN_MARK(i)
#endif

namespace {

constexpr int kWarps = 8;  // warps per block of the point design

// the tap design
constexpr int kTileH = 8;    // canvas rows a block owns
constexpr int kTileW = 32;   // canvas columns a block owns
constexpr int kRing = 4;     // pixels read around the tile
constexpr int kGroup = 4;    // lanes a point
constexpr int kTileThreads = 256;
constexpr int kMaxTileC = 32;  // a lane's channels in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the forward's weight as the image dtype holds it
__device__ __forceinline__ float round_to(float w, float) { return w; }
__device__ __forceinline__ float round_to(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
};
template <typename T>
struct Vec<T, 1> {
  __device__ static void load(const T* p, float* v) { v[0] = to_f32(p[0]); }
};

// VEC values of T from shared memory, as f32 (VEC = 4: one 16 B or 8 B
// load, the address aligned to it)
template <typename T, int VEC>
__device__ __forceinline__ void load_shared(const T* p, float* v) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(p[i]);
  }
}

// a[k] for a k known at run time, without indexing the registers
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[4], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

template <int VEC>
__device__ __forceinline__ void add_to(float* dst, const float* v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
}

// one point's four corners as the forward takes them: image column and row,
// validity, bilinear weight, the weight the forward multiplied by (masked,
// scaled, rounded to T), and the fractions. Columns and rows are 32-bit: a
// position beyond ±2^30 (or NaN) is clamped there, where every corner is
// off the image, as in the plain version.
template <typename T>
struct Corners {
  int ix[4], iy[4];
  bool valid[4];
  float wb[4], wq[4];
  float wx1, wy1, s;

  __device__ __forceinline__ Corners(float x, float y, float scale,
                                     bool scaled, int H, int W) {
    constexpr float kFar = 1073741824.0f;  // 2^30
    const float x0 = floorf(x), y0 = floorf(y);
    wx1 = x - x0;
    wy1 = y - y0;
    s = scale;
    const int x0i = (int)fminf(fmaxf(x0, -kFar), kFar);
    const int y0i = (int)fminf(fmaxf(y0, -kFar), kFar);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ix[k] = x0i + (k & 1);
      iy[k] = y0i + (k >> 1);
      const float fx = (k & 1) ? wx1 : 1.0f - wx1;
      const float fy = (k >> 1) ? wy1 : 1.0f - wy1;
      valid[k] = ix[k] >= 0 && ix[k] < W && iy[k] >= 0 && iy[k] < H;
      wb[k] = fx * fy;
      float w = valid[k] ? wb[k] : 0.0f;
      if (scaled) w *= s;
      wq[k] = round_to(w, T());
    }
  }
};

// d_x, d_y, d_scale of a point from its corners' dot products
template <typename T>
__device__ __forceinline__ void write_rest(const Corners<T>& q,
                                           const float (&dw)[4], long long p,
                                           float* d_x, float* d_y,
                                           float* d_scale) {
  float dwb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) dwb[k] = q.valid[k] ? dw[k] * q.s : 0.0f;
  d_x[p] = -dwb[0] * (1.0f - q.wy1) + dwb[1] * (1.0f - q.wy1) -
           dwb[2] * q.wy1 + dwb[3] * q.wy1;
  d_y[p] = -dwb[0] * (1.0f - q.wx1) - dwb[1] * q.wx1 +
           dwb[2] * (1.0f - q.wx1) + dwb[3] * q.wx1;
  if (d_scale != nullptr) {
    float ds = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) ds += (q.valid[k] ? q.wb[k] : 0.0f) * dw[k];
    d_scale[p] = ds;
  }
}

// ------------------------------------------------------- the point design

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
dcn_sample_bwd_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const float* __restrict__ scale,
                      const T* __restrict__ g, float* __restrict__ acc,
                      float* __restrict__ d_x, float* __restrict__ d_y,
                      float* __restrict__ d_scale, int H, int W, int C,
                      long long P, long long NP) {
  const int lane = threadIdx.x & 31;
  const int groups = C / VEC;  // channel groups a corner
  const int units = 4 * groups;
  const long long HW = (long long)H * W;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long p = warp0; p < NP; p += nwarps) {
    const long long n = p / P;
    const Corners<T> q(xs[p], ys[p], scale != nullptr ? scale[p] : 1.0f,
                       scale != nullptr, H, W);
    long long row[4];  // read for the valid corners only
#pragma unroll
    for (int k = 0; k < 4; ++k)
      row[k] = n * HW + (long long)q.iy[k] * W + q.ix[k];
    const T* gp = g + p * C;
    float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u = lane; u < units; u += 32) {
      const int k = u / groups;
      const int c = (u - k * groups) * VEC;
      if (!pick(q.valid, k)) continue;
      const long long r = pick(row, k);
      const float w = pick(q.wq, k);
      float gv[VEC], iv[VEC], upd[VEC];
      Vec<T, VEC>::load(gp + c, gv);
      Vec<T, VEC>::load(img + r * C + c, iv);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        dot = fmaf(gv[i], iv[i], dot);
        upd[i] = gv[i] * w;
      }
      add_to<VEC>(acc + r * C + c, upd);
      // k is uniform over a lane's unit only: select its slot
#pragma unroll
      for (int j = 0; j < 4; ++j) dw[j] += j == k ? dot : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dw[j] += __shfl_xor_sync(0xffffffffu, dw[j], off);
    }
    if (lane == 0) write_rest(q, dw, p, d_x, d_y, d_scale);
  }
}

// --------------------------------------------------------- the tap design

constexpr int kTilePix = kTileH * kTileW;
static_assert(kTileThreads == kTilePix, "a thread a tile pixel");
constexpr int kRegion = (kTileH + 2 * kRing) * (kTileW + 2 * kRing);
constexpr int kLaneC = kMaxTileC / kGroup;  // channels a lane, at most
constexpr int kRingRows = 128;  // ring points' rows of g staged, at most

// a corner's column and row: the floor clamped to ±2^30 (see Corners)
__device__ __forceinline__ int floor_clamped(float v) {
  constexpr float kFar = 1073741824.0f;
  return (int)fminf(fmaxf(floorf(v), -kFar), kFar);
}

// the weight the forward multiplied corner k of a point by, for a corner on
// the image (Corners' wq)
template <typename T>
__device__ __forceinline__ float corner_wq(float x, float y, float s,
                                           bool scaled, int k) {
  const float wx1 = x - floorf(x), wy1 = y - floorf(y);
  const float fx = (k & 1) ? wx1 : 1.0f - wx1;
  const float fy = (k >> 1) ? wy1 : 1.0f - wy1;
  float w = fx * fy;
  if (scaled) w *= s;
  return round_to(w, T());
}

// does the point at pixel (py, px) lie in the ring-grown tile that holds
// pixel (iy, ix)? If not, its corner at (iy, ix) is a spill
__device__ __forceinline__ bool in_ring(int py, int px, int iy, int ix) {
  const int ty = iy / kTileH * kTileH, tx = ix / kTileW * kTileW;
  return py >= ty - kRing && py < ty + kTileH + kRing && px >= tx - kRing &&
         px < tx + kTileW + kRing;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads)
dcn_sample_bwd_tile(const T* __restrict__ img,
                    const float* __restrict__ xs,
                    const float* __restrict__ ys,
                    const float* __restrict__ scale, const T* __restrict__ g,
                    float* __restrict__ acc, float* __restrict__ d_x,
                    float* __restrict__ d_y, float* __restrict__ d_scale,
                    int H, int W, int C, int tiles_x) {
  // the region's points: position, scale, pixel in the view, tile pixel
  // (-1 in the ring)
  __shared__ float sx[kRegion], sy[kRegion], ss[kRegion];
  __shared__ int pix_of[kRegion];
  __shared__ short own_of[kRegion];
  __shared__ int cnt[kTilePix];            // corners a pixel, then a cursor
  __shared__ int first[kTilePix + 1];      // a pixel's first entry
  __shared__ short entry[4 * kRegion];     // region point · 4 + corner
  __shared__ short ring_slot[kRegion];     // a staged ring row, or -1
  __shared__ int n_ring;
  __shared__ int warp_sum[kTileThreads / 32];
  __shared__ float dw_in[kTilePix][4];     // own points' dw of tile corners
  // the tile's own points' rows of g at their tile pixel, then the rows of
  // up to kRingRows ring points with a corner in the tile (C values each)
  extern __shared__ __align__(16) unsigned char staged[];
  T* own_g = reinterpret_cast<T*>(staged);
  T* ring_g = own_g + kTilePix * C;
  const int t = threadIdx.x;
  DCN_MARK(0);
  const bool scaled = scale != nullptr;
  const int y0 = blockIdx.x / tiles_x * kTileH;
  const int x0 = blockIdx.x % tiles_x * kTileW;
  const int th = min(kTileH, H - y0), tw = min(kTileW, W - x0);
  // the region: the tile grown by the ring, clipped to the image
  const int ry0 = max(0, y0 - kRing), ry1 = min(H, y0 + th + kRing);
  const int rx0 = max(0, x0 - kRing), rx1 = min(W, x0 + tw + kRing);
  const int rw = rx1 - rx0, region = (ry1 - ry0) * rw;
  const long long base = blockIdx.y * (long long)H * W;  // the view's first
  // the tile pixel of corner (ix, iy), or -1 off the tile
  auto tile_pixel = [&](int ix, int iy) {
    return ix >= x0 && ix < x0 + tw && iy >= y0 && iy < y0 + th
               ? (iy - y0) * kTileW + ix - x0
               : -1;
  };

  // 0. stage the own points' rows of g (asynchronously, in 16 B pieces
  // where the rows allow it: they arrive while the lists are built), and
  // the region's points
  const int row_vals = tw * C;  // a tile row's values, contiguous
  const bool async = VEC == 4 && C * sizeof(T) % 16 == 0;
  if (async) {
    const int pieces = row_vals * (int)sizeof(T) / 16;
    for (int i = t; i < th * pieces; i += kTileThreads) {
      const int ly = i / pieces, u = i % pieces;
      const T* src = g + (base + (long long)(y0 + ly) * W + x0) * C;
      __pipeline_memcpy_async(
          staged + (size_t)ly * kTileW * C * sizeof(T) + u * 16,
          reinterpret_cast<const unsigned char*>(src) + u * 16, 16);
    }
    __pipeline_commit();
  } else {
    for (int i = t; i < th * row_vals; i += kTileThreads) {
      const int ly = i / row_vals, e = i % row_vals;
      own_g[ly * kTileW * C + e] =
          g[(base + (long long)(y0 + ly) * W + x0) * C + e];
    }
  }
  for (int r = t; r < region; r += kTileThreads) {
    const int py = ry0 + r / rw, px = rx0 + r % rw;
    const int pix = py * W + px;
    sx[r] = xs[base + pix];
    sy[r] = ys[base + pix];
    ss[r] = scaled ? scale[base + pix] : 1.0f;
    pix_of[r] = pix;
    own_of[r] = (short)tile_pixel(px, py);
  }
  cnt[t] = 0;  // kTileThreads == kTilePix
  if (t == 0) n_ring = 0;
  __syncthreads();
  DCN_MARK(1);

  // 1. count the region's corners that fall on each pixel of the tile, and
  // stage the rows of g of the ring points that have one (asynchronously)
  for (int r = t; r < region; r += kTileThreads) {
    const int fx = floor_clamped(sx[r]), fy = floor_clamped(sy[r]);
    bool hit = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tile_pixel(fx + (k & 1), fy + (k >> 1));
      if (q >= 0) atomicAdd(&cnt[q], 1);
      hit |= q >= 0;
    }
    int slot = -1;
    if (async && hit && own_of[r] < 0) {
      slot = atomicAdd(&n_ring, 1);
      if (slot < kRingRows) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(g + (base + pix_of[r]) * C);
        unsigned char* dst = reinterpret_cast<unsigned char*>(ring_g) +
                             (size_t)slot * C * sizeof(T);
        for (int b = 0; b < C * (int)sizeof(T); b += 16)
          __pipeline_memcpy_async(dst + b, src + b, 16);
      } else {
        slot = -1;
      }
    }
    ring_slot[r] = (short)slot;
  }
  __pipeline_commit();
  __syncthreads();
  DCN_MARK(2);
  // 2. first[q]: the exclusive sum of the counts (a scan over the block)
  {
    const int v = cnt[t];
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, off);
      if (t % 32 >= off) incl += n;
    }
    if (t % 32 == 31) warp_sum[t / 32] = incl;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < t / 32; ++w) before += warp_sum[w];
    first[t] = before + incl - v;
    if (t == kTileThreads - 1) first[kTilePix] = before + incl;
    cnt[t] = 0;
  }
  __syncthreads();
  DCN_MARK(3);
  // 3. list them by pixel, then order each pixel's list: the sums below
  // run in one order whatever the atomics' order was
  for (int r = t; r < region; r += kTileThreads) {
    const int fx = floor_clamped(sx[r]), fy = floor_clamped(sy[r]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tile_pixel(fx + (k & 1), fy + (k >> 1));
      if (q < 0) continue;
      entry[first[q] + atomicAdd(&cnt[q], 1)] = (short)(r * 4 + k);
    }
  }
  __syncthreads();
  for (int i = first[t] + 1; i < first[t + 1]; ++i) {
    const short e = entry[i];
    int j = i - 1;
    for (; j >= first[t] && entry[j] > e; --j) entry[j + 1] = entry[j];
    entry[j + 1] = e;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  DCN_MARK(4);

  // 4. each pixel of the tile, four lanes of VEC channels: the canvas is
  // the sum over its list of wq·g, written once; the dot products of the
  // tile's own points with this pixel's image row go to dw_in. Lane gl
  // takes channel groups gl, gl + 4, ...; the odd points of a warp take
  // them in the other order, so that two points' lanes in a quarter warp
  // read other shared-memory banks
  const int gl = t % kGroup;
  const int flip = t / kGroup % 2;
  const unsigned mine = ((1u << kGroup) - 1u) << (t % 32 / kGroup * kGroup);
  auto chan = [&](int j) {  // the channel of the lane's j-th group
    return (gl + (j / VEC ^ flip) * kGroup) * VEC;
  };
  for (int item = t; item < kTilePix * kGroup; item += kTileThreads) {
    const int q = item / kGroup, ly = q / kTileW, lx = q % kTileW;
    if (ly >= th || lx >= tw) continue;  // the four lanes alike
    const long long row = base + (long long)(y0 + ly) * W + x0 + lx;
    float iv[kLaneC], sum[kLaneC];
#pragma unroll
    for (int j = 0; j < kLaneC; j += VEC) {
      const int c = chan(j);
      if (c < C) Vec<T, VEC>::load(img + row * C + c, iv + j);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[j + i] = 0.0f;
    }
    for (int e = first[q]; e < first[q + 1]; ++e) {
      const int r = entry[e] >> 2, k = entry[e] & 3;
      const float wq = corner_wq<T>(sx[r], sy[r], ss[r], scaled, k);
      const int own = own_of[r], slot = ring_slot[r];
      const bool staged_row = own >= 0 || slot >= 0;
      const T* gp = !staged_row ? g + (base + pix_of[r]) * C
                    : own >= 0  ? own_g + own * C
                                : ring_g + slot * C;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kLaneC; j += VEC) {
        const int c = chan(j);
        if (c >= C) continue;
        float gv[VEC];
        if (staged_row) {
          load_shared<T, VEC>(gp + c, gv);
        } else {
          Vec<T, VEC>::load(gp + c, gv);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sum[j + i] = fmaf(gv[i], wq, sum[j + i]);
          dot = fmaf(gv[i], iv[j + i], dot);
        }
      }
      if (own >= 0) {
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(mine, dot, off);
        if (gl == 0) dw_in[own][k] = dot;
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneC; j += VEC) {
      const int c = chan(j);
      if (c >= C) continue;
      float* dst = acc + row * C + c;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(sum[j], sum[j + 1], sum[j + 2], sum[j + 3]);
      } else {
        dst[0] = sum[j];
      }
    }
  }
  __syncthreads();
  DCN_MARK(5);

  // 5. the tile's own points, four lanes each: dw of their corners off the
  // tile from the image rows, the rest from dw_in; then d_x, d_y, d_scale
  for (int u = t / kGroup; u < th * tw; u += kTileThreads / kGroup) {
    const int ly = u / tw, lx = u % tw;
    const int r = (ly + y0 - ry0) * rw + lx + x0 - rx0;
    const long long p = base + pix_of[r];
    const Corners<T> cq(sx[r], sy[r], ss[r], scaled, H, W);
    bool off_tile[4];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      off_tile[k] = cq.valid[k] && tile_pixel(cq.ix[k], cq.iy[k]) < 0;
      any |= off_tile[k];
    }
    float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (any) {
#pragma unroll
      for (int j = 0; j < kLaneC; j += VEC) {
        const int c = chan(j);
        if (c >= C) continue;
        float gv[VEC];
        load_shared<T, VEC>(own_g + (ly * kTileW + lx) * C + c, gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!off_tile[k]) continue;
          float iv[VEC];
          Vec<T, VEC>::load(
              img + (base + (long long)cq.iy[k] * W + cq.ix[k]) * C + c, iv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) dw[k] = fmaf(gv[i], iv[i], dw[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int off = kGroup / 2; off > 0; off >>= 1)
          dw[k] += __shfl_xor_sync(mine, dw[k], off);
      }
    }
    if (gl == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (cq.valid[k] && !off_tile[k]) dw[k] = dw_in[ly * kTileW + lx][k];
      }
      write_rest(cq, dw, p, d_x, d_y, d_scale);
    }
  }
#ifdef DCN_MARKS
  __syncthreads();
#endif
  DCN_MARK(6);
}

// the corners the tiles left: a thread per point, global atomics into the
// canvas the tiles wrote
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
dcn_sample_bwd_spill(const float* __restrict__ xs,
                     const float* __restrict__ ys,
                     const float* __restrict__ scale,
                     const T* __restrict__ g, float* __restrict__ acc, int H,
                     int W, int C) {
  const int HW = H * W;
  const long long base = blockIdx.y * (long long)HW;  // the view's first
  for (int pix = blockIdx.x * blockDim.x + threadIdx.x; pix < HW;
       pix += gridDim.x * blockDim.x) {
    const long long p = base + pix;
    const int py = pix / W, px = pix - py * W;
    const Corners<T> q(xs[p], ys[p], scale != nullptr ? scale[p] : 1.0f,
                       scale != nullptr, H, W);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!q.valid[k] || in_ring(py, px, q.iy[k], q.ix[k])) continue;
      float* dst = acc + (base + (long long)q.iy[k] * W + q.ix[k]) * C;
      for (int c = 0; c < C; c += VEC) {
        float gv[VEC];
        Vec<T, VEC>::load(g + p * C + c, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) gv[i] *= q.wq[k];
        add_to<VEC>(dst + c, gv);
      }
    }
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// Lets the tile kernel take its staged rows of g (up to 48 KB of dynamic
// shared memory) on the current device: cudaFuncSetAttribute once a device,
// its result kept and returned on every later call there, so a failure
// stops every call and not only the first.
template <typename T, int VEC>
cudaError_t allow_tile_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> state[kMaxDevices];  // 0: not yet, else error + 1
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  auto set = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        dcn_sample_bwd_tile<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kTilePix + kRingRows) * kMaxTileC * (int)sizeof(T));
    if (e != cudaSuccess) cudaGetLastError();  // returned, not left behind
    return e;
  };
  if (device < 0 || device >= kMaxDevices) return set();
  int s = state[device].load(std::memory_order_acquire);
  if (s == 0) {
    s = 1 + (int)set();
    state[device].store(s, std::memory_order_release);
  }
  return (cudaError_t)(s - 1);
}

template <typename T, int VEC>
cudaError_t launch(const void* img, const float* x, const float* y,
                   const float* scale, const void* g, float* acc, float* d_x,
                   float* d_y, float* d_scale, int N, int H, int W, int C,
                   long long P, bool tiled, cudaStream_t stream) {
  const long long NP = (long long)N * P;
  const T* im = static_cast<const T*>(img);
  const T* gr = static_cast<const T*>(g);
  const long long cap = (long long)sm_count() * 8;  // 8 blocks on each SM
  if (!tiled) {
    const long long want = (NP + kWarps - 1) / kWarps;
    dcn_sample_bwd_kernel<T, VEC>
        <<<(int)(want < cap ? want : cap), kWarps * 32, 0, stream>>>(
            im, x, y, scale, gr, acc, d_x, d_y, d_scale, H, W, C, P, NP);
    return cudaSuccess;
  }
  const cudaError_t smem = allow_tile_smem<T, VEC>();
  if (smem != cudaSuccess) return smem;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  dcn_sample_bwd_tile<T, VEC>
      <<<dim3(tiles_x * tiles_y, N), kTileThreads,
         (kTilePix + kRingRows) * C * sizeof(T), stream>>>(
          im, x, y, scale, gr, acc, d_x, d_y, d_scale, H, W, C, tiles_x);
  if (cudaPeekAtLastError() != cudaSuccess) return cudaSuccess;  // see below
  const long long HW = (long long)H * W;  // < 2^31: a thread a point
  dcn_sample_bwd_spill<T, VEC>
      <<<dim3((unsigned)((HW + 255) / 256), N), 256, 0, stream>>>(
          x, y, scale, gr, acc, H, W, C);
  return cudaSuccess;
}

}  // namespace

// img (N, H, W, C) and g (N, P, C) of one dtype (elem_bytes 4: f32, 2:
// bf16), contiguous; x, y, scale (nullable) (N, P) f32; acc (N·H·W, C) f32,
// written whole with `tiled` (the tap design: P = H·W < 2^31, C ≤ 32,
// N ≤ 65535, two launches), zeroed by the caller without it (the point
// design, one launch); d_x, d_y, d_scale (nullable, null with scale) (N, P)
// f32.
// Returns the launches' CUDA error code.
extern "C" int dcn_sample_bwd(const void* img, const float* x, const float* y,
                              const float* scale, const void* g, float* acc,
                              float* d_x, float* d_y, float* d_scale, int N,
                              int H, int W, int C, long long P, int elem_bytes,
                              int tiled, void* stream) {
  const long long NP = (long long)N * P;
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || P < 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      ((scale == nullptr) != (d_scale == nullptr)) ||
      (tiled && (P != (long long)H * W || P > INT_MAX || C > kMaxTileC ||
                 N > 65535))) {
    return (int)cudaErrorInvalidValue;
  }
  if (NP == 0) return 0;
  // 4-channel groups need rows of a multiple of 4 and 16 B aligned bases
  const uintptr_t bases = (uintptr_t)img | (uintptr_t)g | (uintptr_t)acc;
  const bool vec4 = C % 4 == 0 && bases % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (elem_bytes == 4) {
    if (vec4)
      err = launch<float, 4>(img, x, y, scale, g, acc, d_x, d_y, d_scale, N,
                             H, W, C, P, tiled, s);
    else
      err = launch<float, 1>(img, x, y, scale, g, acc, d_x, d_y, d_scale, N,
                             H, W, C, P, tiled, s);
  } else {
    if (vec4)
      err = launch<__nv_bfloat16, 4>(img, x, y, scale, g, acc, d_x, d_y,
                                     d_scale, N, H, W, C, P, tiled, s);
    else
      err = launch<__nv_bfloat16, 1>(img, x, y, scale, g, acc, d_x, d_y,
                                     d_scale, N, H, W, C, P, tiled, s);
  }
  // the launches' own errors wait in cudaGetLastError
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
