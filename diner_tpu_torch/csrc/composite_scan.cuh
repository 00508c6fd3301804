// Warp scans shared by the compositing kernels A (composite_fwd.cu) and B
// (composite_bwd.cu), so that the two compute alpha and T the same way.
//
// A ray's samples are taken in chunks of kWidth (32: a warp per ray, or 16:
// half a warp), one sample per lane of the ray's segment of the warp: lane
// k of chunk c holds sample kWidth * c + k. Lanes past the ray's K are
// "invalid": they contribute a factor 1 to products and 0 to sums. Every
// lane of the warp must call a scan (the shuffles name the full mask).

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr unsigned kFull = 0xffffffffu;

// alpha_k = 1 - exp(-delta_k * max(sigma_k, 0)), and 0 on invalid lanes
__device__ __forceinline__ float alpha_of(float delta, float sigma,
                                          bool valid) {
  return valid ? 1.0f - expf(-delta * fmaxf(sigma, 0.0f)) : 0.0f;
}

// Exclusive product scan of (1 - alpha + 1e-10) over the segment: returns
// prod_{j < lane} (1 - alpha_j + 1e-10) (1 on lane 0) and sets *chunk_prod
// to the product over the whole segment, the factor by which the chunk
// carries T into the next one. T_k = (T at the chunk's start) * result.
template <int kWidth = 32>
__device__ __forceinline__ float transmittance_scan(float alpha, bool valid,
                                                    int lane,
                                                    float* chunk_prod) {
  float incl = valid ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
  for (int d = 1; d < kWidth; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d, kWidth);
    if (lane >= d) incl *= y;
  }
  float excl = __shfl_up_sync(kFull, incl, 1, kWidth);
  if (lane == 0) excl = 1.0f;
  *chunk_prod = __shfl_sync(kFull, incl, kWidth - 1, kWidth);
  return excl;
}

// Exclusive suffix sum over the segment: returns sum_{j > lane} v_j (0 on
// its last lane), summed from the last lane down in a tree
// (__shfl_down_sync), and sets *chunk_sum to the sum over the segment. No
// value is ever subtracted, so a small suffix keeps its own relative
// precision.
template <int kWidth = 32>
__device__ __forceinline__ float suffix_sum_scan(float v, int lane,
                                                 float* chunk_sum) {
  float incl = v;
#pragma unroll
  for (int d = 1; d < kWidth; d <<= 1) {
    const float y = __shfl_down_sync(kFull, incl, d, kWidth);
    if (lane + d < kWidth) incl += y;
  }
  float excl = __shfl_down_sync(kFull, incl, 1, kWidth);
  if (lane == kWidth - 1) excl = 0.0f;
  *chunk_sum = __shfl_sync(kFull, incl, 0, kWidth);
  return excl;
}

}  // namespace composite
