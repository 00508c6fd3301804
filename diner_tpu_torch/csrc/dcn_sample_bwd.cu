// Backward of the DCN sampler (bilinear sampling at pixel positions, zeros
// outside, an optional per-point scale folded into the corner weights) —
// CUDA C++ for Hopper (sm_90a).
//
// Replaces diner_tpu/mvs/dcn.py:_bsp_bwd (the custom VJP of
// _bilinear_sample_pix, with _bsp_bwd_rest). That backward is XLA, not
// Pallas: it pairs the two x-adjacent corners of each point into one 2C-wide
// row of parity canvases because the TPU's scatter ran at a tenth of its
// gather rate. Here a corner's update is an f32 atomic add into one (N·H·W, C)
// canvas, which Hopper's L2 does at its own rate, so the pairing has no
// counterpart; the function is the same.
//
// What it computes, for each point p of (N, P) and each corner k of its 4:
//   acc[idx_k(p), c] += wq_k(p) · g[p, c]            (f32 atomics)
//   dw_k(p)  = Σ_c g[p, c] · img[idx_k(p), c]        (f32)
//   d_x(p)   = Σ_k ±dwb_k · (1 − wy1 | wy1),  d_y likewise with wx1,
//   d_scale  = Σ_k wbase_k · dw_k,  dwb_k = dw_k · scale (0 off the image),
// with the corner indices, the validity mask and the weights redone in f32
// exactly as the forward (mvs/dcn.py:bilinear_sample_pix) computes them, and
// wq_k the forward's weight rounded to the image dtype (what the forward
// multiplied by). A corner off the image adds nothing (the plain version adds
// g·0 at its clamped index). The wrapper zeroes the canvas and casts it to
// the image dtype once (ops/dcn_cuda.py).
//
// Bound: bytes. g read once (N·P·C), each distinct image row that a valid
// corner touches read once, x, y, scale read and d_x, d_y, d_scale written
// once, d_img written once. At the stage-3 tap of the 512×640 training step
// (N = 4, P = 327,680, C = 32 f32): g 168 MB, the touched rows ≈ 168 MB,
// d_img 168 MB, the six (N, P) vectors 31 MB: ≈ 0.53 GB, 0.16 ms at
// 3.35 TB/s. The arithmetic (4 multiply-adds and 4 adds a corner and channel)
// is far below the f32 rate.
//
// Design (simple first): a warp per point in a grid-stride loop. Its units
// are (corner, group of VEC channels): lanes take units in order, so at C =
// 32 with VEC = 4 the four corners' 8 groups fill the 32 lanes and one point
// is one pass. A lane loads its group of g and of the corner's image row
// (VEC = 4: 16 B of f32 or 8 B of bf16), adds the weighted g into the canvas
// with one float4 atomic (sm_90) or VEC scalar ones, and keeps a partial dot
// product per corner; four butterfly sums over the warp give dw_0..3, and
// lane 0 writes d_x, d_y, d_scale. VEC = 4 needs C % 4 == 0 (rows then
// 16 B / 8 B aligned) and 16 B aligned bases; otherwise VEC = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps per block

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
    const float x = xs[p], y = ys[p];
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx1 = x - x0, wy1 = y - y0;
    const long long x0i = (long long)x0, y0i = (long long)y0;
    const float s = scale != nullptr ? scale[p] : 1.0f;
    // per corner: its bilinear weight (pre-mask), validity, row
    float wb[4], wq[4];
    bool valid[4];
    long long row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long ix = x0i + (k & 1), iy = y0i + (k >> 1);
      const float fx = (k & 1) ? wx1 : 1.0f - wx1;
      const float fy = (k >> 1) ? wy1 : 1.0f - wy1;
      valid[k] = ix >= 0 && ix < W && iy >= 0 && iy < H;
      wb[k] = fx * fy;
      float w = valid[k] ? wb[k] : 0.0f;
      if (scale != nullptr) w *= s;
      wq[k] = round_to(w, T());
      const long long cx = ix < 0 ? 0 : (ix >= W ? W - 1 : ix);
      const long long cy = iy < 0 ? 0 : (iy >= H ? H - 1 : iy);
      row[k] = n * HW + cy * W + cx;
    }
    const T* gp = g + p * C;
    float dw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int u = lane; u < units; u += 32) {
      const int k = u / groups;
      const int c = (u - k * groups) * VEC;
      if (!pick(valid, k)) continue;
      const long long r = pick(row, k);
      const float w = pick(wq, k);
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
    if (lane == 0) {
      float dwb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) dwb[k] = valid[k] ? dw[k] * s : 0.0f;
      d_x[p] = -dwb[0] * (1.0f - wy1) + dwb[1] * (1.0f - wy1) -
               dwb[2] * wy1 + dwb[3] * wy1;
      d_y[p] = -dwb[0] * (1.0f - wx1) - dwb[1] * wx1 +
               dwb[2] * (1.0f - wx1) + dwb[3] * wx1;
      if (d_scale != nullptr) {
        float ds = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) ds += (valid[k] ? wb[k] : 0.0f) * dw[k];
        d_scale[p] = ds;
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* img, const float* x, const float* y,
            const float* scale, const void* g, float* acc, float* d_x,
            float* d_y, float* d_scale, int H, int W, int C, long long P,
            long long NP, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (NP + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * 8;  // 8 blocks of 256 on each SM
  const int blocks = (int)(want < cap ? want : cap);
  dcn_sample_bwd_kernel<T, VEC><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(img), x, y, scale, static_cast<const T*>(g), acc,
      d_x, d_y, d_scale, H, W, C, P, NP);
}

}  // namespace

// img (N, H, W, C) and g (N, P, C) of one dtype (elem_bytes 4: f32, 2:
// bf16), contiguous; x, y, scale (nullable) (N, P) f32; acc (N·H·W, C) f32,
// zeroed by the caller; d_x, d_y, d_scale (nullable, null with scale) (N, P)
// f32. Returns the launch's CUDA error code.
extern "C" int dcn_sample_bwd(const void* img, const float* x, const float* y,
                              const float* scale, const void* g, float* acc,
                              float* d_x, float* d_y, float* d_scale, int N,
                              int H, int W, int C, long long P, int elem_bytes,
                              void* stream) {
  const long long NP = (long long)N * P;
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || P < 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      ((scale == nullptr) != (d_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (NP == 0) return 0;
  // 4-channel groups need rows of a multiple of 4 and 16 B aligned bases
  const uintptr_t bases = (uintptr_t)img | (uintptr_t)g | (uintptr_t)acc;
  const bool vec4 = C % 4 == 0 && bases % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    if (vec4)
      launch<float, 4>(img, x, y, scale, g, acc, d_x, d_y, d_scale, H, W, C,
                       P, NP, s);
    else
      launch<float, 1>(img, x, y, scale, g, acc, d_x, d_y, d_scale, H, W, C,
                       P, NP, s);
  } else {
    if (vec4)
      launch<__nv_bfloat16, 4>(img, x, y, scale, g, acc, d_x, d_y, d_scale,
                               H, W, C, P, NP, s);
    else
      launch<__nv_bfloat16, 1>(img, x, y, scale, g, acc, d_x, d_y, d_scale,
                               H, W, C, P, NP, s);
  }
  return (int)cudaGetLastError();
}
