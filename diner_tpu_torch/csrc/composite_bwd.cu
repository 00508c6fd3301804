// Fused alpha compositing, backward — CUDA C++ for Hopper (sm_90a).
//
// Replaces diner_tpu/ops/pallas/composite_pallas.py:_bwd_kernel (launched by
// _core_bwd, the VJP bound by _composite_core.defvjp). Per ray, with
//   dL/dw_k = c_k . g_rgb + z_k * g_depth + g_w_k  (- sum g_rgb, white bkgd)
//   S_k     = sum_{j>k} dL/dw_j * w_j
//   dL/da_k = T_k * dL/dw_k - S_k / (1 - a_k + 1e-10)
// it writes d_sigma_k = dL/da_k * delta_k * exp(-delta_k * max(sigma_k, 0))
// * [sigma_k > 0] and d_rgb_k = w_k * g_rgb. z and far get no gradient. All
// f32.
//
// Bound: at the training step's R = 4096 rays, K = 40 a launch reads rgb,
// sigma and z (5RK floats) plus far and g_rgb (4R) and writes d_rgb and
// d_sigma (4RK): about 6.0 MB, about 1.8 us at 3.35 TB/s; with g_w and
// g_depth it reads RK + R floats more. Some 40 flops per sample stay far
// below the f32 peak. So it is bound by bytes, and in practice by the
// latency of one launch over 4096 short rays.
//
// Design (kernel A's, composite_fwd.cu): a warp per ray, four rays per
// 128-thread block (1,024 blocks at R = 4096, one wave on 132 SMs), or half
// a warp per ray in 16-sample chunks where those pad K less (K = 40: 48
// lanes' work instead of 64; K = 64: a tie, a warp). Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (lab/composite_bwd_variants.py): half a warp
// ties at 4096 x 40, is 15 % faster at 8192 x 40 and 4096 x 100, and 14 %
// slower at 4096 x 64. Lanes take consecutive samples, so the loads of
// rgb, sigma and z coalesce (a ray's samples sit 16 B apart in one run of
// the field's (R, K, 4) output). Two passes over the chunks:
//   forward:  alpha per lane, T from the exclusive product scan of
//             (1 - alpha + 1e-10) that kernel A uses (composite_scan.cuh),
//             carried across chunks;
//   reverse:  from the last chunk to the first, S_k as an exclusive suffix
//             sum scan of dL/dw_j * w_j over the warp (__shfl_down_sync)
//             plus the sum of the chunks after this one, as the Pallas
//             kernel's reverse pass sums from the last sample down.
// Where K <= 64 (the training step's 40 and the eval path's 64) each lane
// keeps its samples and T in registers between the passes, all loads in
// flight at once; for a larger K the forward pass keeps T at each chunk's
// start in dynamic shared memory (one float per chunk and ray) and the
// reverse pass reloads each chunk (from L2), the next one's loads issued
// before this one's arithmetic. d_sigma is written coalesced; d_rgb, three
// floats per sample, as three runs of consecutive floats, each lane
// fetching its sample's w with __shfl_sync. Null g_depth or g_w are read as
// zero (the training step uses neither output, so autograd hands none).
// rgb, sigma and z are read through strides, so the field's (R, K, 4)
// output is not copied; the gradients are written contiguous.
//
// Tolerance: T_k is the product scan's, as in kernel A (a few f32 roundings
// of T_k from torch.cumprod's order). S_k is a sum of the same terms as the
// plain version's reverse cumsum, in a tree within each chunk: it never
// subtracts, so its error is some ulps of sum_{j>k} |dL/dw_j * w_j|, which
// shrinks with S_k itself where alpha_k nears 1 and the 1e-10 floor divides
// it. (The first version of this kernel took S_k = total - prefix_k, whose
// error of one ulp of the whole ray's sum that floor amplified.) The card
// check holds d_rgb within 1e-5 and d_sigma within 1e-5 of its largest
// value of the plain version, with samples at alpha ~ 1 or without.

#include <cuda_runtime.h>

#include "composite_scan.cuh"

namespace {

using composite::kFull;

constexpr int kBlock = 128;
constexpr int kRegSamples = 64;  // K up to this keeps its chunks in registers

struct Args {
  const float* rgb;
  long long rgb_sr, rgb_sk, rgb_sc;
  const float* sigma;
  long long sig_sr, sig_sk;
  const float* z;
  long long z_sr, z_sk;
  const float* far;
  long long far_s;
  const float* g_rgb;
  long long g_rgb_sr, g_rgb_sc;
  const float* g_depth;
  long long g_depth_s;
  const float* g_w;
  long long g_w_sr, g_w_sk;
  float* d_rgb;
  float* d_sigma;
  int R, K, white_bkgd;
};

struct Sample {
  float z, z_next, sigma, r, g, b, gw;
};

// One ray's view of the inputs, for the lanes of its segment.
struct Ray {
  const float *c, *s, *zr, *gw;
  long long r;
  float far, g0, g1, g2, gd, g_sum;
  bool ok;  // r < R (a segment past the last ray still runs the scans)

  __device__ Sample load(const Args& a, int k) const {
    Sample x{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (k < a.K) {
      x.z = zr[k * a.z_sk];
      x.z_next = k + 1 < a.K ? zr[(k + 1) * a.z_sk] : far;
      x.sigma = s[k * a.sig_sk];
      const float* ck = c + k * a.rgb_sk;
      x.r = ck[0];
      x.g = ck[a.rgb_sc];
      x.b = ck[2 * a.rgb_sc];
      if (gw) x.gw = gw[k * a.g_w_sk];
    }
    return x;
  }

  // dL/dw_k from the sample's colour, depth and weight cotangent
  __device__ float dldw(const Sample& x) const {
    float v = (x.r * g0 + x.g * g1) + x.b * g2;
    if (gd != 0.0f) v += x.z * gd;
    return (v + x.gw) - g_sum;
  }
};

// The reverse pass over one chunk (c) whose lanes hold sample x with
// transmittance t. carry is the sum of dL/dw_j * w_j over the chunks after
// this one; returns it with this chunk's terms added.
template <int kWidth>
__device__ __forceinline__ float backward_chunk(const Args& a, const Ray& ray,
                                                const Sample& x, float t,
                                                int c, int lane,
                                                float carry) {
  const int k = c * kWidth + lane;
  const bool valid = k < a.K;
  const float delta = x.z_next - x.z;
  const float decay = expf(-delta * fmaxf(x.sigma, 0.0f));
  const float alpha = composite::alpha_of(delta, x.sigma, valid);
  const float w = alpha * t;
  const float dldw = ray.dldw(x);
  float chunk_sum;
  const float after = composite::suffix_sum_scan<kWidth>(
      valid ? dldw * w : 0.0f, lane, &chunk_sum);
  const float s_k = carry + after;
  const float shifted = (1.0f - alpha) + 1e-10f;
  const float dlda = t * dldw - s_k / shifted;
  if (ray.ok && valid)
    a.d_sigma[ray.r * a.K + k] = x.sigma > 0.0f ? dlda * (delta * decay)
                                                : 0.0f;
  // d_rgb of the chunk's samples: 3 * kWidth consecutive floats
  float* out = a.d_rgb + (ray.r * a.K + c * kWidth) * 3;
  const int n_out = 3 * min(kWidth, a.K - c * kWidth);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int m = lane + kWidth * j;
    const float wm = __shfl_sync(kFull, w, m / 3, kWidth);
    const int ch = m - 3 * (m / 3);
    const float g = ch == 0 ? ray.g0 : (ch == 1 ? ray.g1 : ray.g2);
    if (ray.ok && m < n_out) out[m] = wm * g;
  }
  return carry + chunk_sum;
}

// kWidth lanes per ray; kRegChunks > 0: K <= kRegChunks * kWidth, samples
// and T kept in registers; 0: T at chunk starts in dynamic shared memory.
template <int kWidth, int kRegChunks>
__global__ void __launch_bounds__(kBlock) composite_bwd_kernel(Args a) {
  constexpr int kRaysPerBlock = kBlock / kWidth;
  const int seg = threadIdx.x / kWidth;
  const int lane = threadIdx.x % kWidth;
  Ray ray;
  const long long r = (long long)blockIdx.x * kRaysPerBlock + seg;
  ray.ok = r < a.R;
  ray.r = ray.ok ? r : a.R - 1;
  ray.c = a.rgb + ray.r * a.rgb_sr;
  ray.s = a.sigma + ray.r * a.sig_sr;
  ray.zr = a.z + ray.r * a.z_sr;
  ray.gw = a.g_w ? a.g_w + ray.r * a.g_w_sr : nullptr;
  ray.far = a.far[ray.r * a.far_s];
  ray.g0 = a.g_rgb[ray.r * a.g_rgb_sr];
  ray.g1 = a.g_rgb[ray.r * a.g_rgb_sr + a.g_rgb_sc];
  ray.g2 = a.g_rgb[ray.r * a.g_rgb_sr + 2 * a.g_rgb_sc];
  ray.gd = a.g_depth ? a.g_depth[ray.r * a.g_depth_s] : 0.0f;
  ray.g_sum = a.white_bkgd ? (ray.g0 + ray.g1) + ray.g2 : 0.0f;
  const int n_chunks = (a.K + kWidth - 1) / kWidth;

  if constexpr (kRegChunks > 0) {
    Sample xs[kRegChunks];
    float ts[kRegChunks];
#pragma unroll
    for (int c = 0; c < kRegChunks; ++c)  // every load in flight at once
      if (c < n_chunks) xs[c] = ray.load(a, c * kWidth + lane);
    float trans = 1.0f;
#pragma unroll
    for (int c = 0; c < kRegChunks; ++c) {
      if (c < n_chunks) {
        const bool valid = c * kWidth + lane < a.K;
        const float alpha =
            composite::alpha_of(xs[c].z_next - xs[c].z, xs[c].sigma, valid);
        float chunk_prod;
        ts[c] = trans * composite::transmittance_scan<kWidth>(
                            alpha, valid, lane, &chunk_prod);
        trans *= chunk_prod;
      }
    }
    float carry = 0.0f;
#pragma unroll
    for (int c = kRegChunks - 1; c >= 0; --c)
      if (c < n_chunks)
        carry = backward_chunk<kWidth>(a, ray, xs[c], ts[c], c, lane, carry);
  } else {
    extern __shared__ float t_start_all[];
    float* t_start = t_start_all + seg * n_chunks;
    float trans = 1.0f;
    Sample next = ray.load(a, lane);
    for (int c = 0; c < n_chunks; ++c) {
      const Sample x = next;
      if (c + 1 < n_chunks) next = ray.load(a, (c + 1) * kWidth + lane);
      const bool valid = c * kWidth + lane < a.K;
      const float alpha = composite::alpha_of(x.z_next - x.z, x.sigma, valid);
      float chunk_prod;
      composite::transmittance_scan<kWidth>(alpha, valid, lane, &chunk_prod);
      if (lane == 0) t_start[c] = trans;
      trans *= chunk_prod;
    }
    __syncwarp();
    float carry = 0.0f;
    next = ray.load(a, (n_chunks - 1) * kWidth + lane);
    for (int c = n_chunks - 1; c >= 0; --c) {
      const Sample x = next;
      if (c > 0) next = ray.load(a, (c - 1) * kWidth + lane);
      const bool valid = c * kWidth + lane < a.K;
      const float alpha = composite::alpha_of(x.z_next - x.z, x.sigma, valid);
      float chunk_prod;
      const float t = t_start[c] * composite::transmittance_scan<kWidth>(
                                       alpha, valid, lane, &chunk_prod);
      carry = backward_chunk<kWidth>(a, ray, x, t, c, lane, carry);
    }
  }
}

// Launches kWidth lanes per ray; returns cudaGetLastError() (0 on success).
template <int kWidth>
int launch_bwd(const Args& a, cudaStream_t stream) {
  constexpr int kRaysPerBlock = kBlock / kWidth;
  const int grid = (a.R + kRaysPerBlock - 1) / kRaysPerBlock;
  if (a.K <= kRegSamples) {
    composite_bwd_kernel<kWidth, kRegSamples / kWidth>
        <<<grid, kBlock, 0, stream>>>(a);
  } else {
    const size_t smem =
        sizeof(float) * kRaysPerBlock * ((a.K + kWidth - 1) / kWidth);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          composite_bwd_kernel<kWidth, 0>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    composite_bwd_kernel<kWidth, 0><<<grid, kBlock, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// Half a warp per ray where 16-sample chunks cover K with fewer padded
// lanes than 32-sample ones.
bool half_warp_pads_less(int K) {
  return (K + 15) / 16 * 16 < (K + 31) / 32 * 32;
}

Args make_args(const float* rgb, long long rgb_sr, long long rgb_sk,
               long long rgb_sc, const float* sigma, long long sig_sr,
               long long sig_sk, const float* z, long long z_sr,
               long long z_sk, const float* far, long long far_s,
               const float* g_rgb, long long g_rgb_sr, long long g_rgb_sc,
               const float* g_depth, long long g_depth_s, const float* g_w,
               long long g_w_sr, long long g_w_sk, float* d_rgb,
               float* d_sigma, int R, int K, int white_bkgd) {
  return Args{rgb,     rgb_sr,    rgb_sk, rgb_sc, sigma,    sig_sr,
              sig_sk,  z,         z_sr,   z_sk,   far,      far_s,
              g_rgb,   g_rgb_sr,  g_rgb_sc, g_depth, g_depth_s, g_w,
              g_w_sr,  g_w_sk,    d_rgb,  d_sigma, R,       K,
              white_bkgd};
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// g_depth and g_w may be null (read as zero). Outputs are contiguous:
// d_rgb (R, K, 3), d_sigma (R, K). K above 64 keeps T at each chunk's start
// in shared memory for the block's rays, 2 B per sample with half a warp
// per ray, at most 227 KB: K <= 116,224.
extern "C" int composite_bwd(
    const float* rgb, long long rgb_sr, long long rgb_sk, long long rgb_sc,
    const float* sigma, long long sig_sr, long long sig_sk,
    const float* z, long long z_sr, long long z_sk,
    const float* far, long long far_s,
    const float* g_rgb, long long g_rgb_sr, long long g_rgb_sc,
    const float* g_depth, long long g_depth_s,
    const float* g_w, long long g_w_sr, long long g_w_sk,
    float* d_rgb, float* d_sigma, int R, int K, int white_bkgd,
    void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  const Args a = make_args(rgb, rgb_sr, rgb_sk, rgb_sc, sigma, sig_sr,
                           sig_sk, z, z_sr, z_sk, far, far_s, g_rgb,
                           g_rgb_sr, g_rgb_sc, g_depth, g_depth_s, g_w,
                           g_w_sr, g_w_sk, d_rgb, d_sigma, R, K, white_bkgd);
  return half_warp_pads_less(K) ? launch_bwd<16>(a, (cudaStream_t)stream)
                                : launch_bwd<32>(a, (cudaStream_t)stream);
}
