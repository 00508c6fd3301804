// Top-1 nearest vertex of every point (the mesh deformation of NOVEL) —
// CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's diner_tpu/ops/knn.py:knn1 (an MXU matmul over
// (chunk, V) distance tiles, itself standing in for pytorch3d's CUDA
// knn_points with K = 1 in the reference's NOVEL renderer). It is no Pallas
// kernel; the port gives it a kernel because at NOVEL's own size it holds the
// step: the sampler deforms all 1,000 candidates of 4,096 rays against
// FaceScape's 26,317 mesh vertices, 1.08e11 point-vertex pairs a step.
//
// What it computes, for each scene s and point i:
//   out[s, i] = argmin_v  d2(v),   d2(v) = |v|² − 2·(p·v)
// with |p|² dropped (constant per point), every product and sum rounded on
// its own in the order
//   p·v = (px·vx + py·vy) + pz·vz,  |v|² = (vx·vx + vy·vy) + vz·vz,
//   d2 = (−2 · p·v) + |v|²
// which is what the plain PyTorch version (ops/knn_cuda.py:knn1_plain)
// computes with elementwise tensor ops, so the two pick the same vertex.
// The last step is one fmaf(−2, dot, |v|²): multiplying by −2 is exact, so
// the fused form rounds once where the plain version rounds once, bit for
// bit. Ties go to the lower original index and NaN follows argmin: the first
// NaN distance wins over every number and over later NaNs.
//
// Bound: bytes. The function reads each point and vertex once and writes
// each index once; any exact search tests at least each point's own nearest
// vertex (4 FP32 multiply-add-class operations a pair, 3 for the dot
// product and 1 for d2), far fewer operations than the bytes' time. At the
// sampler's 4,096,000 points × 26,317 vertices that is 65.9 MB, 0.0197 ms
// at 3.35 TB/s (chip_smoke.py:knn_bound). Testing every pair would take
// 12.9 ms at the 67 TFLOP/s FP32 rate: the brute-force design (one thread a
// point over every vertex, ≈ 11 instructions a pair) sat at 42 ms, bound by
// its instruction rate. This one tests fewer pairs where the points are
// coherent, as the sampler's are (ray-major: 32 consecutive points lie on
// one ray, within ≈ 3 % of its depth range); how many it tests is its own
// work, reported beside the bound (chip_smoke.py:knn_tested_pairs), not a
// bound.
//
// Design. The wrapper (ops/knn_cuda.py:tile_plan) orders each scene's
// vertices by a 30-bit Morton code of their coordinates, quantised to the
// finite vertices' bounding box (non-finite vertices last), and cuts that
// order into tiles of `tile` vertices. Within a tile the vertices stand in
// increasing original index. Per tile it stores its box, R1 (the largest
// |x| + |y| + |z|, a bound on |v|) and m (the largest |coordinate|, NaN if
// one is NaN); every `rep_stride`-th vertex of the Morton order is a
// representative. Those are plain tensor ops (a radix sort of 26,317 keys
// is a library call, and the plan is a few kB the kernel only reads); the
// argmin is all here.
//
// One thread per point, 8 warps a block, blockIdx.y the scene. A thread
// first takes ub = min d2 over the representatives: a real vertex's rounded
// d2, so no better than the answer. Then it walks the tiles in order. For
// each, a lane computes a lower bound of every rounded d2 in the tile:
//   lb = Σ_k c_k·(c_k − 2 p_k) − margin,   c_k = clamp(p_k, lo_k, hi_k),
// the least |v|² − 2p·v over the box, less
//   margin = 2^-18 · R1·(R1 + 2·P1) + 1e-36,  P1 = |px| + |py| + |pz|,
// 64u (u = 2^-24) times R1² + 2·R1·P1: the rounding of d2 reaches ≈ 4u·R1²
// + 8u·R1·P1 and that of lb ≈ 15u·R1² + 10u·R1·P1 (its three clamps may
// come from three vertices), so the margin holds them with room to spare.
// The warp skips the tile only when every active lane's lb exceeds its own
// min(ub, best): each lane holds its own best (d2 drops |p|², so bests are
// not comparable across lanes). A tile that is scanned gives its least d2
// with the strict `<` (the lowest index of a tie, the tile being in index
// order) and is merged into the running best with the lexicographic rule
// (d2, index): tiles come out of index order, so a tie across tiles goes to
// the lower original index.
//
// NaN: checking for NaN on every pair cost 47 % in the brute-force design
// (lab/knn1_variants.py), so it runs only where a NaN can arise: finite
// inputs with max|p|·max|v| < 1e37 give finite products and dot products,
// and |v|² can only overflow to +inf, so d2 is a number or +inf. A lane for
// which p_max·m fails that bound (m NaN or inf included) scans the tile with
// the NaN-aware compare and never votes to skip it, so a tile where a NaN
// can arise is always scanned.
//
// Where the bytes are: the whole plan (26,317 float4 vertices, their
// indices, 206 boxes, 823 representatives) is ≈ 0.55 MB, in L2. The block
// stages the representatives and the boxes in shared memory, 256 boxes or
// 512 representatives at a time, and each warp stages a tile it scans in
// its own 2.5 KB of shared memory, so every lane reads each vertex as a
// shared-memory broadcast (as the brute-force design did; reading them
// straight from L1 at one address a warp took 53 ms, not 42, on the
// uniform points). N and V need not be multiples of the block or the tile
// (tile ≤ 128). Offsets are 64-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;           // points per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 128;           // vertices a tile, at most
constexpr int kChunk = 256;             // representatives or boxes staged
constexpr float kMarginScale = 0x1p-18f;
constexpr float kMarginFloor = 1e-36f;  // underflow of the terms
constexpr float kSafeProduct = 1e37f;   // max|p|·max|v| below: no NaN

// |v|² − 2·p·v, every operation rounded on its own; −2·dot is exact, so
// fmaf(−2, dot, sq) rounds as (−2·dot) + sq does
__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float4 v) {
  float dot = __fadd_rn(__fmul_rn(px, v.x), __fmul_rn(py, v.y));
  dot = __fadd_rn(dot, __fmul_rn(pz, v.z));
  return fmaf(-2.f, dot, v.w);
}

__device__ __forceinline__ float abs_max(float x, float y, float z) {
  return __uint_as_float(max(max(__float_as_uint(x) & 0x7fffffffu,
                                 __float_as_uint(y) & 0x7fffffffu),
                             __float_as_uint(z) & 0x7fffffffu));
}

// the least d2 of n vertices in index order, and its position (strict <:
// the first of a tie); NaN-aware: the first NaN wins
template <bool kNanAware>
__device__ __forceinline__ void scan_tile(const float4* tile, int n,
                                          float px, float py, float pz,
                                          float& tb, int& tj) {
  tb = __int_as_float(0x7f800000);  // +inf
  tj = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float d2 = dist2(px, py, pz, tile[j]);
    const bool take = kNanAware ? d2 < tb || (d2 != d2 && tb == tb)
                                : d2 < tb;
    if (take) {
      tb = d2;
      tj = j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn1_kernel(const float* __restrict__ points, const float4* __restrict__ verts,
            const int* __restrict__ vidx, const float4* __restrict__ boxes,
            const float4* __restrict__ reps, int* __restrict__ out,
            unsigned long long* __restrict__ scanned, long long N, int V,
            int tile, int n_reps) {
  __shared__ float4 s_chunk[2 * kChunk];  // representatives, then boxes
  __shared__ float4 s_tile[kWarps][kMaxTile];
  __shared__ int s_idx[kWarps][kMaxTile];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long s = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < N;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) {
    const float* p = points + (s * N + i) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const float p_max = abs_max(px, py, pz);
  const float p1 = (fabsf(px) + fabsf(py)) + fabsf(pz);
  const int T = (V + tile - 1) / tile;
  const float4* vs = verts + s * V;
  const int* is = vidx + s * V;
  const float4* bs = boxes + s * T * 2;
  const float4* rs = reps + s * n_reps;

  float ub = __int_as_float(0x7f800000);
  for (int r0 = 0; r0 < n_reps; r0 += 2 * kChunk) {
    const int m = min(2 * kChunk, n_reps - r0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) s_chunk[j] = rs[r0 + j];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      ub = fminf(ub, dist2(px, py, pz, s_chunk[j]));
    }
  }

  float best = __int_as_float(0x7f800000);
  int best_i = INT_MAX;
  unsigned n_scanned = 0;
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int m = min(kChunk, T - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * m; j += kThreads)
      s_chunk[j] = bs[2 * c0 + j];
    __syncthreads();
    for (int c = 0; c < m; ++c) {
      // (lo x, lo y, lo z, hi x), (hi y, hi z, R1, m)
      const float4 b0 = s_chunk[2 * c], b1 = s_chunk[2 * c + 1];
      const bool safe = p_max * b1.w < kSafeProduct;  // false for NaN, inf
      bool skip = !active;
      if (active && safe) {
        const float cx = fminf(fmaxf(px, b0.x), b0.w);
        const float cy = fminf(fmaxf(py, b0.y), b1.x);
        const float cz = fminf(fmaxf(pz, b0.z), b1.y);
        const float lb = (cx * (cx - 2.f * px) + cy * (cy - 2.f * py)) +
                         cz * (cz - 2.f * pz);
        const float margin =
            fmaf(kMarginScale, b1.z * fmaf(2.f, p1, b1.z), kMarginFloor);
        skip = lb - margin > fminf(ub, best);
      }
      if (__all_sync(0xffffffffu, skip)) continue;
      ++n_scanned;
      // the warp stages the tile, then every lane scans it from there
      const int t0 = (c0 + c) * tile;
      const int n = min(tile, V - t0);
      __syncwarp();
      for (int j = lane; j < n; j += 32) {
        s_tile[warp][j] = vs[t0 + j];
        s_idx[warp][j] = is[t0 + j];
      }
      __syncwarp();
      float tb;
      int tj;
      if (safe) {
        scan_tile<false>(s_tile[warp], n, px, py, pz, tb, tj);
      } else {
        scan_tile<true>(s_tile[warp], n, px, py, pz, tb, tj);
      }
      const int ti = s_idx[warp][tj];
      const bool take = tb != tb ? (best == best || ti < best_i)
                                 : (tb < best || (tb == best && ti < best_i));
      if (take) {
        best = tb;
        best_i = ti;
      }
    }
  }
  if (active) out[s * N + i] = best_i;
  if (scanned != nullptr && lane == 0) {
    atomicAdd(scanned, (unsigned long long)n_scanned);
  }
}

}  // namespace

// points (SB, N, 3) f32; the plan of ops/knn_cuda.py:tile_plan: verts
// (SB, V, 4) f32 (x, y, z, |v|²) in tile order, vidx (SB, V) int32 original
// indices, boxes (SB, ceil(V / tile), 8) f32, reps (SB, n_reps, 4) f32; out
// (SB, N) int32; scanned (nullable) gets the tiles the warps scanned. All
// contiguous. Returns the CUDA error of the launch (0 if none).
extern "C" int knn1(const float* points, const float* verts, const int* vidx,
                    const float* boxes, const float* reps, int* out,
                    unsigned long long* scanned, long long N, int V, int tile,
                    int n_reps, int SB, cudaStream_t stream) {
  if (N < 0 || V < 1 || tile < 1 || tile > kMaxTile || n_reps < 1 ||
      SB < 1 || SB > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return 0;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)SB);
  knn1_kernel<<<grid, kThreads, 0, stream>>>(
      points, reinterpret_cast<const float4*>(verts), vidx,
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(reps), out, scanned, N, V, tile,
      n_reps);
  return (int)cudaGetLastError();
}
