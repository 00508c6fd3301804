// Design variants of the top-1 kNN kernel, timed by lab/knn1_variants.py.
// Includes the package's source (csrc/knn1.cu, the tile-cull design), and
// keeps the first design beside it in namespace brute_force, as it was:
// one thread per point over every vertex in 32 KB shared tiles, the
// NaN-aware compare only on tiles where a NaN can arise.
//
//   0  the package's launcher (tile cull; the plan from
//      ops/knn_cuda.py:tile_plan);
//   1  the brute-force launcher;
//   2  the brute-force design with the NaN-aware compare on every pair;
//   3  the brute-force design with the strict d2 < best on every pair: a
//      NaN distance never wins, which is not argmin's rule.

#include "../diner_tpu_torch/csrc/knn1.cu"

namespace brute_force {

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
int launch(const float* points, const float* verts, int* out, long long N,
           int V, int SB, cudaStream_t stream) {
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

namespace {

template <bool kNanAware>
__global__ void __launch_bounds__(kThreads)
knn1_every_pair(const float* __restrict__ points,
                const float* __restrict__ verts, int* __restrict__ out,
                long long N, int V) {
  __shared__ float4 tile[kTile];
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
  const float* vs = verts + s * (long long)V * 3;
  float best = __int_as_float(0x7f800000);
  int best_i = 0;
  for (int t0 = 0; t0 < V; t0 += kTile) {
    const int n = min(kTile, V - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* v = vs + (long long)(t0 + j) * 3;
      tile[j] = make_float4(v[0], v[1], v[2], sq_norm(v[0], v[1], v[2]));
    }
    __syncthreads();
    if (active) scan_tile<kNanAware>(tile, n, t0, px, py, pz, best, best_i);
  }
  if (active) out[s * N + i] = best_i;
}

}  // namespace

int every_pair(bool nan_aware, const float* points, const float* verts,
               int* out, long long N, int V, int SB, cudaStream_t stream) {
  if (N == 0) return 0;
  dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)SB);
  if (nan_aware) {
    knn1_every_pair<true><<<grid, kThreads, 0, stream>>>(points, verts, out,
                                                          N, V);
  } else {
    knn1_every_pair<false><<<grid, kThreads, 0, stream>>>(points, verts,
                                                           out, N, V);
  }
  return (int)cudaGetLastError();
}

}  // namespace brute_force

// points (SB, N, 3), verts (SB, V, 3) and, for variant 0, the plan of
// ops/knn_cuda.py:tile_plan; out (SB, N) int32
extern "C" int lab(int variant, const float* points, const float* verts,
                   const float* plan_verts, const int* vidx,
                   const float* boxes, const float* reps, int* out,
                   long long N, int V, int tile, int n_reps, int SB,
                   cudaStream_t stream) {
  switch (variant) {
    case 0:
      return knn1(points, plan_verts, vidx, boxes, reps, out, nullptr, N, V,
                  tile, n_reps, SB, stream);
    case 1:
      return brute_force::launch(points, verts, out, N, V, SB, stream);
    default:
      return brute_force::every_pair(variant == 2, points, verts, out, N, V,
                                     SB, stream);
  }
}
