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
// g_depth it reads RK + R floats more. Some 50 flops per sample stay far
// below the f32 peak. Like kernel A, a launch is bound by latency (launch
// cost and two dependent loops of K steps per ray), not by bandwidth.
//
// Design: one thread per ray and two forward walks over its samples, with
// all state in registers. The Pallas kernel unrolls a static K and keeps
// alpha, T, delta and the gate in K-long lists for a reverse pass; here K is
// a runtime value (40 in training, 64 in eval) and a 4K-float array per
// thread would spill. The first walk sums total = sum_j dL/dw_j * w_j; the
// second recomputes alpha, T and w and takes S_k = total - prefix_k, where
// prefix_k sums the same terms through k in the same order. The difference
// rounds otherwise than the Pallas reverse suffix: its absolute error is
// about one f32 ulp of the sum of |dL/dw_j * w_j|. In d_sigma it is
// multiplied by delta_k * exp(-delta_k sigma_k) / (1 - a_k + 1e-10), which
// is delta_k while 1 - a_k is well above 1e-10; only where a_k rounds to 1
// (delta_k * sigma_k about 17 to 23) does the 1e-10 floor let it grow, by
// at most some 600-fold, still some 1e-5 of the ray's scale.
// Null g_depth or g_w are read as zero (the training step uses neither
// output, so autograd hands none). Blocks are 32 threads, as for kernel A,
// so 4096 rays spread over 128 SMs. rgb, sigma and z are read through
// strides, so the field's (R, K, 4) output is not copied; the gradients are
// written contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;

__global__ void composite_bwd_kernel(
    const float* __restrict__ rgb, long long rgb_sr, long long rgb_sk,
    long long rgb_sc,
    const float* __restrict__ sigma, long long sig_sr, long long sig_sk,
    const float* __restrict__ z, long long z_sr, long long z_sk,
    const float* __restrict__ far, long long far_s,
    const float* __restrict__ g_rgb, long long g_rgb_sr, long long g_rgb_sc,
    const float* __restrict__ g_depth, long long g_depth_s,
    const float* __restrict__ g_w, long long g_w_sr, long long g_w_sk,
    float* __restrict__ d_rgb, float* __restrict__ d_sigma,
    int R, int K, int white_bkgd) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* c = rgb + r * rgb_sr;
  const float* s = sigma + r * sig_sr;
  const float* zr = z + r * z_sr;
  const float* gw = g_w ? g_w + r * g_w_sr : nullptr;
  const float g0 = g_rgb[r * g_rgb_sr];
  const float g1 = g_rgb[r * g_rgb_sr + g_rgb_sc];
  const float g2 = g_rgb[r * g_rgb_sr + 2 * g_rgb_sc];
  const float gd = g_depth ? g_depth[r * g_depth_s] : 0.0f;
  const float g_sum = white_bkgd ? (g0 + g1) + g2 : 0.0f;
  const float far_r = far[r * far_s];

  // dL/dw_k from the sample's colour and depth
  auto dldw_at = [&](int k, float zk) {
    const float* ck = c + k * rgb_sk;
    float v = (ck[0] * g0 + ck[rgb_sc] * g1) + ck[2 * rgb_sc] * g2;
    if (g_depth) v += zk * gd;
    if (gw) v += gw[k * g_w_sk];
    return v - g_sum;
  };

  // walk 1: total = sum_k dL/dw_k * w_k
  float trans = 1.0f, total = 0.0f;
  float zk = zr[0];
  for (int k = 0; k < K; ++k) {
    const float z_next = (k == K - 1) ? far_r : zr[(k + 1) * z_sk];
    const float delta = z_next - zk;
    const float alpha = 1.0f - expf(-delta * fmaxf(s[k * sig_sk], 0.0f));
    total += dldw_at(k, zk) * (alpha * trans);
    trans *= (1.0f - alpha) + 1e-10f;
    zk = z_next;
  }

  // walk 2: S_k = total - prefix_k, then the gradients of sample k
  float* d_sig_row = d_sigma + r * K;
  float* d_rgb_row = d_rgb + r * K * 3;
  float prefix = 0.0f;
  trans = 1.0f;
  zk = zr[0];
  for (int k = 0; k < K; ++k) {
    const float z_next = (k == K - 1) ? far_r : zr[(k + 1) * z_sk];
    const float delta = z_next - zk;
    const float sig_raw = s[k * sig_sk];
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

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// g_depth and g_w may be null (read as zero). Outputs are contiguous:
// d_rgb (R, K, 3), d_sigma (R, K).
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
  if (R > 0 && K > 0) {
    const int grid = (R + kBlock - 1) / kBlock;
    composite_bwd_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        rgb, rgb_sr, rgb_sk, rgb_sc, sigma, sig_sr, sig_sk, z, z_sr, z_sk,
        far, far_s, g_rgb, g_rgb_sr, g_rgb_sc, g_depth, g_depth_s, g_w,
        g_w_sr, g_w_sk, d_rgb, d_sigma, R, K, white_bkgd);
  }
  return (int)cudaGetLastError();
}
