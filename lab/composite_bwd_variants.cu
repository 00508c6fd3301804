// Design variants of kernel B, the compositing backward, for
// lab/composite_bwd_variants.py. Includes the package's kernel
// (diner_tpu_torch/csrc/composite_bwd.cu) and launches its templates with
// other choices than the package's launcher makes:
//   0  the package's launcher (half a warp per ray where it pads K less)
//   1  a warp per ray, K <= 64 in registers
//   2  half a warp per ray (16-sample chunks), K <= 64 in registers
//   3  a warp per ray, T at chunk starts in shared memory at every K
//   4  half a warp per ray, shared memory at every K
//   5  the first kernel B: a thread per ray, two walks, S_k = total - prefix_k
// Not part of the package.

#include "../diner_tpu_torch/csrc/composite_bwd.cu"

namespace {

template <int kWidth, bool kShared>
int lab_launch(const Args& a, cudaStream_t stream) {
  constexpr int kRaysPerBlock = kBlock / kWidth;
  const int grid = (a.R + kRaysPerBlock - 1) / kRaysPerBlock;
  if (!kShared && a.K <= kRegSamples) {
    composite_bwd_kernel<kWidth, kRegSamples / kWidth>
        <<<grid, kBlock, 0, stream>>>(a);
  } else {
    const size_t smem =
        sizeof(float) * kRaysPerBlock * ((a.K + kWidth - 1) / kWidth);
    composite_bwd_kernel<kWidth, 0><<<grid, kBlock, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The first kernel B, as it shipped (one thread per ray in 32-thread blocks)
__global__ void thread_per_ray_bwd_kernel(Args a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const int K = a.K;
  const float* c = a.rgb + r * a.rgb_sr;
  const float* s = a.sigma + r * a.sig_sr;
  const float* zr = a.z + r * a.z_sr;
  const float* gw = a.g_w ? a.g_w + r * a.g_w_sr : nullptr;
  const float g0 = a.g_rgb[r * a.g_rgb_sr];
  const float g1 = a.g_rgb[r * a.g_rgb_sr + a.g_rgb_sc];
  const float g2 = a.g_rgb[r * a.g_rgb_sr + 2 * a.g_rgb_sc];
  const float gd = a.g_depth ? a.g_depth[r * a.g_depth_s] : 0.0f;
  const float g_sum = a.white_bkgd ? (g0 + g1) + g2 : 0.0f;
  const float far_r = a.far[r * a.far_s];
  auto dldw_at = [&](int k, float zk) {
    const float* ck = c + k * a.rgb_sk;
    float v = (ck[0] * g0 + ck[a.rgb_sc] * g1) + ck[2 * a.rgb_sc] * g2;
    if (a.g_depth) v += zk * gd;
    if (gw) v += gw[k * a.g_w_sk];
    return v - g_sum;
  };
  float trans = 1.0f, total = 0.0f;
  float zk = zr[0];
  for (int k = 0; k < K; ++k) {
    const float z_next = (k == K - 1) ? far_r : zr[(k + 1) * a.z_sk];
    const float delta = z_next - zk;
    const float alpha = 1.0f - expf(-delta * fmaxf(s[k * a.sig_sk], 0.0f));
    total += dldw_at(k, zk) * (alpha * trans);
    trans *= (1.0f - alpha) + 1e-10f;
    zk = z_next;
  }
  float* d_sig_row = a.d_sigma + r * K;
  float* d_rgb_row = a.d_rgb + r * K * 3;
  float prefix = 0.0f;
  trans = 1.0f;
  zk = zr[0];
  for (int k = 0; k < K; ++k) {
    const float z_next = (k == K - 1) ? far_r : zr[(k + 1) * a.z_sk];
    const float delta = z_next - zk;
    const float sig_raw = s[k * a.sig_sk];
    const float decay = expf(-delta * fmaxf(sig_raw, 0.0f));
    const float alpha = 1.0f - decay;
    const float w = alpha * trans;
    const float dldw = dldw_at(k, zk);
    prefix += dldw * w;
    const float shifted = (1.0f - alpha) + 1e-10f;
    const float dlda = trans * dldw - (total - prefix) / shifted;
    d_sig_row[k] = sig_raw > 0.0f ? dlda * (delta * decay) : 0.0f;
    d_rgb_row[3 * k] = w * g0;
    d_rgb_row[3 * k + 1] = w * g1;
    d_rgb_row[3 * k + 2] = w * g2;
    trans *= shifted;
    zk = z_next;
  }
}

}  // namespace

extern "C" int lab(
    int variant,
    const float* rgb, long long rgb_sr, long long rgb_sk, long long rgb_sc,
    const float* sigma, long long sig_sr, long long sig_sk,
    const float* z, long long z_sr, long long z_sk,
    const float* far, long long far_s,
    const float* g_rgb, long long g_rgb_sr, long long g_rgb_sc,
    const float* g_depth, long long g_depth_s,
    const float* g_w, long long g_w_sr, long long g_w_sk,
    float* d_rgb, float* d_sigma, int R, int K, int white_bkgd,
    void* stream) {
  const Args a = make_args(rgb, rgb_sr, rgb_sk, rgb_sc, sigma, sig_sr,
                           sig_sk, z, z_sr, z_sk, far, far_s, g_rgb,
                           g_rgb_sr, g_rgb_sc, g_depth, g_depth_s, g_w,
                           g_w_sr, g_w_sk, d_rgb, d_sigma, R, K, white_bkgd);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return half_warp_pads_less(K) ? launch_bwd<16>(a, s)
                                    : launch_bwd<32>(a, s);
    case 1: return lab_launch<32, false>(a, s);
    case 2: return lab_launch<16, false>(a, s);
    case 3: return lab_launch<32, true>(a, s);
    case 4: return lab_launch<16, true>(a, s);
    case 5:
      thread_per_ray_bwd_kernel<<<(R + 31) / 32, 32, 0, s>>>(a);
      return (int)cudaGetLastError();
  }
  return -1;
}
