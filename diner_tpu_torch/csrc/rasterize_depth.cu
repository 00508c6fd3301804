// Mesh z-buffer (kernel R) — CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's diner_tpu/preprocessing/rasterize.py:24
// rasterize_depth (jitted XLA, no Pallas: pixel blocks × face chunks under
// lax.map / lax.scan), which stands in for the reference's pyrender/EGL
// ground-truth depth of the FaceScape and multiface preprocessing.
//
// What it computes, for each pixel centre p = (x + 0.5, y + 0.5) of an
// H × W map, from the projected vertices uv (V, 2) and camera depths z (V)
// (projected once by ops/rasterize_cuda.py:project, shared with the plain
// version) and the faces (F, 3):
//   d = p − v0, e1 = v1 − v0, e2 = v2 − v0
//   denom = e1.x·e2.y − e1.y·e2.x
//   b1 = (d.x·e2.y − d.y·e2.x) / denom, b2 = (e1.x·d.y − e1.y·d.x) / denom
//   b0 = (1 − b1) − b2
//   covered  ⇔ the face is valid, b0, b1, b2 ≥ 0, and p lies in the face's
//              screen bounding box grown by one pixel
//   depth    = 1 / max((b0/z0 + b1/z1) + b2/z2, 1e-9)
// and writes the least depth over the faces that cover p, 0 where none
// does. A face is valid when z0, z1, z2 > znear and |denom| ≥ 1e-12: the
// JAX function clamps |denom| < 1e-12 to 1e-12 instead, so a collapsed face
// (three equal vertices) has b1 = b2 = 0 at every pixel and covers the
// whole map; the port drops such faces, as pyrender draws no fragment for a
// zero-area triangle. The bounding-box term changes nothing for a face whose
// barycentrics are not dominated by rounding (an inside point lies in the
// box); it makes the tile cull below exact, so the kernel and the plain
// version (ops/rasterize_cuda.py:rasterize_depth_plain) agree bit for bit.
// Every operation is rounded on its own (__fmul_rn / __fsub_rn / __fadd_rn /
// __fdiv_rn, no contraction into an FMA), in the order above.
//
// Bound: bytes. At 2048×1334 on a 50,400-face head mesh the bytes (the
// 10.9 MB map, the 0.9 MB mesh) take 3.5 µs at 3.35 TB/s. The pair tests a
// z-buffer needs, the pixel centres inside each face's grown box, are
// 3.4e6: at 15 operations each 0.75 µs over the 67 TFLOP/s FP32 rate. This
// kernel's 16×16 tile cull leaves 8 times as many (2.7e7); the dense
// product H·W·F is 1.4e11 pair tests, 31 ms.
//
// Design (simple first): a setup kernel computes one record per face
// (v0, e1, e2, denom, z0..z2 and the grown box, an empty box for an invalid
// face). The raster kernel takes a block per 16×16 pixel tile: in chunks of
// 256 faces each thread tests one face's box against the tile, the
// survivors are compacted into shared memory (warp ballot), and then every
// thread (one pixel) evaluates them in face order. Every block still reads
// every face's box (dense in F): 1.30 ms at that size (chip_smoke.py's
// kernel_rasterize, H100 80GB HBM3 at 700 W); binning faces to tiles
// first is the redesign that makes large maps cheap. Offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;                // pixels per tile side
constexpr int kThreads = kTile * kTile;  // one thread per pixel
constexpr int kChunk = kThreads;         // faces tested per pass

struct Face {
  float4 a;    // v0.x, v0.y, e1.x, e1.y
  float4 b;    // e2.x, e2.y, denom, z0
  float4 c;    // z1, z2, unused, unused
};

__device__ __forceinline__ float min3(float a, float b, float c) {
  float m = a < b ? a : b;
  return m < c ? m : c;
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  float m = a > b ? a : b;
  return m > c ? m : c;
}

__global__ void setup_kernel(const float* __restrict__ uv,
                             const float* __restrict__ z,
                             const int* __restrict__ faces, int F,
                             float znear, Face* __restrict__ rec,
                             float4* __restrict__ box) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int i0 = faces[3LL * f], i1 = faces[3LL * f + 1],
            i2 = faces[3LL * f + 2];
  const float u0 = uv[2LL * i0], v0 = uv[2LL * i0 + 1];
  const float u1 = uv[2LL * i1], v1 = uv[2LL * i1 + 1];
  const float u2 = uv[2LL * i2], v2 = uv[2LL * i2 + 1];
  const float z0 = z[i0], z1 = z[i1], z2 = z[i2];
  const float e1x = __fsub_rn(u1, u0), e1y = __fsub_rn(v1, v0);
  const float e2x = __fsub_rn(u2, u0), e2y = __fsub_rn(v2, v0);
  const float denom = __fsub_rn(__fmul_rn(e1x, e2y), __fmul_rn(e1y, e2x));
  const bool valid = z0 > znear && z1 > znear && z2 > znear &&
                     fabsf(denom) >= 1e-12f;  // false for a NaN denom
  rec[f] = Face{make_float4(u0, v0, e1x, e1y), make_float4(e2x, e2y, denom, z0),
                make_float4(z1, z2, 0.f, 0.f)};
  const float inf = __int_as_float(0x7f800000);
  box[f] = valid ? make_float4(__fsub_rn(min3(u0, u1, u2), 1.f),
                               __fadd_rn(max3(u0, u1, u2), 1.f),
                               __fsub_rn(min3(v0, v1, v2), 1.f),
                               __fadd_rn(max3(v0, v1, v2), 1.f))
                 : make_float4(inf, -inf, inf, -inf);
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const Face* __restrict__ rec, const float4* __restrict__ box,
              int F, int H, int W, float* __restrict__ out) {
  __shared__ Face s_rec[kChunk];
  __shared__ float4 s_box[kChunk];
  __shared__ int s_count;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int x = x0 + tx, y = y0 + ty;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  // the tile's extreme pixel centres inside the map
  const float tx_lo = (float)x0 + 0.5f;
  const float tx_hi = (float)min(x0 + kTile, W) - 0.5f;
  const float ty_lo = (float)y0 + 0.5f;
  const float ty_hi = (float)min(y0 + kTile, H) - 0.5f;
  const int lane = threadIdx.x % 32;
  float best = __int_as_float(0x7f800000);  // +inf

  for (int f0 = 0; f0 < F; f0 += kChunk) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();  // the previous chunk is read by every thread
    const int f = f0 + threadIdx.x;
    bool hit = false;
    float4 bx;
    if (f < F) {
      bx = box[f];
      hit = bx.x <= tx_hi && bx.y >= tx_lo && bx.z <= ty_hi && bx.w >= ty_lo;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (hit) {
      // keep face order inside a warp; warps may interleave, and the min
      // over faces does not depend on the order
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      s_rec[slot] = rec[f];
      s_box[slot] = bx;
    }
    __syncthreads();
    const int n = s_count;
    if (x < W && y < H) {
      for (int j = 0; j < n; ++j) {
        const float4 b = s_box[j];
        if (!(px >= b.x && px <= b.y && py >= b.z && py <= b.w)) continue;
        const Face r = s_rec[j];
        const float dx = __fsub_rn(px, r.a.x), dy = __fsub_rn(py, r.a.y);
        const float e1x = r.a.z, e1y = r.a.w, e2x = r.b.x, e2y = r.b.y;
        const float denom = r.b.z;
        const float b1 = __fdiv_rn(
            __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x)), denom);
        const float b2 = __fdiv_rn(
            __fsub_rn(__fmul_rn(e1x, dy), __fmul_rn(e1y, dx)), denom);
        const float b0 = __fsub_rn(__fsub_rn(1.f, b1), b2);
        if (!(b0 >= 0.f && b1 >= 0.f && b2 >= 0.f)) continue;
        float inv_z = __fadd_rn(__fdiv_rn(b0, r.b.w), __fdiv_rn(b1, r.c.x));
        inv_z = __fadd_rn(inv_z, __fdiv_rn(b2, r.c.y));
        inv_z = inv_z < 1e-9f ? 1e-9f : inv_z;
        const float depth = __fdiv_rn(1.f, inv_z);
        best = depth < best ? depth : best;
      }
    }
  }
  if (x < W && y < H) {
    out[(long long)y * W + x] = best == __int_as_float(0x7f800000) ? 0.f
                                                                   : best;
  }
}

}  // namespace

// uv (V, 2) f32, z (V) f32, faces (F, 3) int32 (indices in [0, V)), all
// contiguous; rec (F × 48 B) and box (F × 16 B) scratch; out (H, W) f32.
// Returns the CUDA error of the launches (0 if none).
extern "C" int rasterize_depth(const float* uv, const float* z,
                               const int* faces, int F, float znear, int H,
                               int W, void* rec, void* box, float* out,
                               cudaStream_t stream) {
  if (F < 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long gx = (W + kTile - 1) / kTile, gy = (H + kTile - 1) / kTile;
  if (gy > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (F > 0) {
    setup_kernel<<<(F + 255) / 256, 256, 0, stream>>>(
        uv, z, faces, F, znear, static_cast<Face*>(rec),
        static_cast<float4*>(box));
  }
  raster_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, stream>>>(
      static_cast<const Face*>(rec), static_cast<const float4*>(box), F, H,
      W, out);
  return (int)cudaGetLastError();
}
