// Design variants of the top-1 kNN kernel (csrc/knn1.cu), timed by
// lab/knn1_variants.py. Includes the package's source, so its helpers
// (dist2, sq_norm, scan_tile) and its launcher are this file's too.
//
//   0  the package's launcher: the NaN-aware compare only on tiles where a
//      NaN can arise;
//   1  the NaN-aware compare (d2 < best || (d2 NaN && best not NaN)) on
//      every pair;
//   2  the strict d2 < best on every pair: a NaN distance never wins, which
//      is not argmin's rule.

#include "../diner_tpu_torch/csrc/knn1.cu"

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

extern "C" int lab(int variant, const float* points, const float* verts,
                   int* out, long long N, int V, int SB,
                   cudaStream_t stream) {
  if (variant == 0) return knn1(points, verts, out, N, V, SB, stream);
  if (N == 0) return 0;
  dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)SB);
  if (variant == 1) {
    knn1_every_pair<true><<<grid, kThreads, 0, stream>>>(points, verts, out,
                                                          N, V);
  } else {
    knn1_every_pair<false><<<grid, kThreads, 0, stream>>>(points, verts,
                                                           out, N, V);
  }
  return (int)cudaGetLastError();
}
