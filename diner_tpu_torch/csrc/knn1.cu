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
// its own (__fmul_rn / __fadd_rn, no contraction into an FMA) in the order
//   p·v = (px·vx + py·vy) + pz·vz,  |v|² = (vx·vx + vy·vy) + vz·vz,
//   d2 = (−2 · p·v) + |v|²
// which is what the plain PyTorch version (ops/knn_cuda.py:knn1_plain)
// computes with elementwise tensor ops, so the two pick the same vertex.
// Ties go to the lower index: the running minimum moves only on a strictly
// smaller d2, and vertices are visited in increasing index (argmin's rule).
// NaN follows argmin too: the first NaN distance wins over every number and
// over later NaNs (a point with a NaN coordinate gets index 0). Checking for
// NaN on every pair took 61.9 ms against 42.2 at the sampler's shape
// (lab/knn1_variants.py, H100 80GB HBM3 at 700 W), so the check runs only
// where a NaN can arise: finite inputs with max|p|·max|v| < 1e37
// give finite products and dot products, and |v|² can only overflow to
// +inf, so d2 is a number or +inf. Each tile's max|coordinate| (NaN above
// +inf, as bits) is reduced while it loads; a thread scans the tile with the
// NaN-aware compare only when its point and the tile fail that bound.
//
// Bound: operations. 4 FP32 multiply-add-class operations a pair (3 for the
// dot product, 1 for d2), counted as 8 FLOPs over the 67 TFLOP/s FP32 rate:
// at the sampler's 4,096,000 points × 26,317 vertices, 12.9 ms. The bytes
// (12 B a point and 4 B an index, 12 B a vertex) are 66 MB, 0.02 ms.
//
// Design (simple first): one thread per point, its coordinates and its
// running (best d2, best index) in registers; blockIdx.y is the scene. The
// block stages its scene's vertices through shared memory in tiles of
// kTile as float4 (x, y, z, |v|²), |v|² computed once per tile load; every
// thread of the block then reads each vertex as a broadcast. N and V need
// not be multiples of the block or the tile. Offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // points per block
constexpr int kTile = 2048;    // vertices per shared tile (32 KB)

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// |v|² − 2·p·v, every operation rounded on its own
__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float x, float y, float z, float sq) {
  float dot = __fadd_rn(__fmul_rn(px, x), __fmul_rn(py, y));
  dot = __fadd_rn(dot, __fmul_rn(pz, z));
  return __fadd_rn(__fmul_rn(-2.f, dot), sq);
}

// the bits of max(|x|, |y|, |z|): NaN orders above +inf as unsigned ints
__device__ __forceinline__ unsigned abs_max_bits(float x, float y, float z) {
  return max(max(__float_as_uint(x) & 0x7fffffffu,
                 __float_as_uint(y) & 0x7fffffffu),
             __float_as_uint(z) & 0x7fffffffu);
}

// one shared tile of n vertices, starting at vertex t0, into (best, best_i)
template <bool kNanAware>
__device__ __forceinline__ void scan_tile(const float4* tile, int n, int t0,
                                          float px, float py, float pz,
                                          float& best, int& best_i) {
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const float4 v = tile[j];
    const float d2 = dist2(px, py, pz, v.x, v.y, v.z, v.w);
    const bool take = kNanAware ? d2 < best || (d2 != d2 && best == best)
                                : d2 < best;
    if (take) {
      best = d2;
      best_i = t0 + j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn1_kernel(const float* __restrict__ points, const float* __restrict__ verts,
            int* __restrict__ out, long long N, int V) {
  __shared__ float4 tile[kTile];
  __shared__ unsigned warp_max[kThreads / 32];
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
  const float p_max = __uint_as_float(abs_max_bits(px, py, pz));
  const float* vs = verts + s * (long long)V * 3;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int t0 = 0; t0 < V; t0 += kTile) {
    const int n = min(kTile, V - t0);
    __syncthreads();  // the previous tile is read by every thread
    unsigned m = 0;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* v = vs + (long long)(t0 + j) * 3;
      tile[j] = make_float4(v[0], v[1], v[2], sq_norm(v[0], v[1], v[2]));
      m = max(m, abs_max_bits(v[0], v[1], v[2]));
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
    __syncthreads();
    if (active) {
      for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
      if (p_max * __uint_as_float(m) < 1e37f) {  // false for NaN, inf
        scan_tile<false>(tile, n, t0, px, py, pz, best, best_i);
      } else {
        scan_tile<true>(tile, n, t0, px, py, pz, best, best_i);
      }
    }
  }
  if (active) out[s * N + i] = best_i;
}

}  // namespace

// points (SB, N, 3) f32, verts (SB, V, 3) f32, out (SB, N) int32, all
// contiguous. Returns the CUDA error of the launch (0 if none).
extern "C" int knn1(const float* points, const float* verts, int* out,
                    long long N, int V, int SB, cudaStream_t stream) {
  if (N < 0 || V < 1 || SB < 1 || SB > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (N == 0) return 0;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)SB);
  knn1_kernel<<<grid, kThreads, 0, stream>>>(points, verts, out, N, V);
  return (int)cudaGetLastError();
}
