// Multi-view depth-map consistency fusion (CPU/OpenMP).
//
// TPU-era replacement for the reference's CUDA fusibile kernel
// (deps/TransMVSNet/deps/fusibile/fusibile.cu:138-280): for every pixel of
// every reference view, backproject its depth, reproject into each other
// view, convert both depths to disparities via the ref focal length and the
// camera baseline, and accept the pixel when enough views agree within
// disp_thresh (and the normal angle within normal_thresh). Consistent
// points/normals/colors are averaged over (count + 1) as in the reference.
//
// Exposed as a C ABI for ctypes; parallelized over reference-view pixels
// with OpenMP. No CUDA, no external dependencies.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <atomic>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Vec3 {
    float x, y, z;
};

inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(Vec3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }

// One camera: P = K [R|t] (3x4 row-major), M = P[:, :3], p4 = P[:, 3].
struct Camera {
    float M[9];
    float Minv[9];
    Vec3 p4;
    Vec3 center;  // -Minv * p4
    float f;      // focal (pixels) for disparity conversion
};

inline Vec3 matvec3(const float* A, Vec3 v) {
    return {A[0] * v.x + A[1] * v.y + A[2] * v.z,
            A[3] * v.x + A[4] * v.y + A[5] * v.z,
            A[6] * v.x + A[7] * v.y + A[8] * v.z};
}

bool invert3(const float* m, float* inv) {
    const double a = m[0], b = m[1], c = m[2];
    const double d = m[3], e = m[4], f = m[5];
    const double g = m[6], h = m[7], i = m[8];
    const double A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
    const double det = a * A + b * B + c * C;
    if (std::fabs(det) < 1e-20) return false;
    const double s = 1.0 / det;
    inv[0] = (float)(A * s);
    inv[1] = (float)(-(b * i - c * h) * s);
    inv[2] = (float)((b * f - c * e) * s);
    inv[3] = (float)(B * s);
    inv[4] = (float)((a * i - c * g) * s);
    inv[5] = (float)(-(a * f - c * d) * s);
    inv[6] = (float)(C * s);
    inv[7] = (float)(-(a * h - b * g) * s);
    inv[8] = (float)((a * e - b * d) * s);
    return true;
}

// Backproject pixel (px, py) at depth d: X = Minv * (d*px - p4x, d*py - p4y,
// d - p4z)  [fusibile get3Dpoint_cu]
inline Vec3 backproject(const Camera& cam, float px, float py, float d) {
    Vec3 pt{d * px - cam.p4.x, d * py - cam.p4.y, d - cam.p4.z};
    return matvec3(cam.Minv, pt);
}

// Project X: x = M*X + p4; pt = (x/z, y/z), depth = z
inline void project(const Camera& cam, Vec3 X, float* u, float* v, float* depth) {
    Vec3 x = matvec3(cam.M, X) + cam.p4;
    *u = x.x / x.z;
    *v = x.y / x.z;
    *depth = x.z;
}

inline float disparity(float f, float baseline, float d) {
    return f * baseline / d;
}

inline float angle_between(Vec3 a, Vec3 b) {
    float ang = std::acos(dot(a, b));
    if (ang != ang) return 0.0f;  // NaN → identical vectors
    return ang;
}

}  // namespace

extern "C" {

// Fuse depth maps into a point cloud.
//
// depths:  (V, rows, cols) float32
// normals: (V, rows, cols, 3) float32 (unit; zero where invalid)
// colors:  (V, rows, cols, 3) float32 or nullptr
// P:       (V, 12) row-major 3x4 projection matrices
// focals:  (V,) focal lengths in pixels
// out:     capacity x 10 floats [x y z nx ny nz r g b nconsistent]
// Returns the number of points written (clamped to capacity), or -1 on a
// singular camera matrix.
long long fuse_depth_maps(int n_views, int rows, int cols,
                          const float* depths, const float* normals,
                          const float* colors, const float* P,
                          const float* focals, float disp_thresh,
                          float normal_thresh, int num_consistent,
                          float* out, long long capacity) {
    if (n_views <= 0) return 0;
    Camera* cams = new Camera[n_views];
    for (int v = 0; v < n_views; ++v) {
        const float* p = P + 12 * v;
        Camera& c = cams[v];
        c.M[0] = p[0]; c.M[1] = p[1]; c.M[2] = p[2];  c.p4.x = p[3];
        c.M[3] = p[4]; c.M[4] = p[5]; c.M[5] = p[6];  c.p4.y = p[7];
        c.M[6] = p[8]; c.M[7] = p[9]; c.M[8] = p[10]; c.p4.z = p[11];
        if (!invert3(c.M, c.Minv)) {
            delete[] cams;
            return -1;
        }
        c.center = matvec3(c.Minv, c.p4) * -1.0f;
        c.f = focals[v];
    }

    const long long hw = (long long)rows * cols;
    std::atomic<long long> count{0};

    for (int ref = 0; ref < n_views; ++ref) {
        const Camera& rc = cams[ref];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
        for (long long pix = 0; pix < hw; ++pix) {
            const int py = (int)(pix / cols);
            const int px = (int)(pix % cols);
            const float d = depths[ref * hw + pix];
            if (d <= 0.0f) continue;
            const float* nr = normals + (ref * hw + pix) * 3;
            Vec3 n{nr[0], nr[1], nr[2]};

            Vec3 X = backproject(rc, (float)px, (float)py, d);
            Vec3 cX = X;
            Vec3 cN = n;
            Vec3 cC{1.0f, 1.0f, 1.0f};
            if (colors) {
                const float* cr = colors + (ref * hw + pix) * 3;
                cC = {cr[0], cr[1], cr[2]};
            }
            int consistent = 0;
            for (int v = 0; v < n_views; ++v) {
                if (v == ref) continue;
                float u, w, dproj;
                project(cams[v], X, &u, &w, &dproj);
                if (!(u >= 0 && u < cols && w >= 0 && w < rows)) continue;
                // texture fetch at (pt + 0.5) with point sampling →
                // texel floor(pt + 0.5), CLAMPED like a CUDA texture with
                // unnormalized coords (u ∈ [cols-0.5, cols) reads the last
                // texel); backprojection uses (int)pt
                int fu = (int)std::floor(u + 0.5f);
                int fv = (int)std::floor(w + 0.5f);
                fu = fu >= cols ? cols - 1 : fu;
                fv = fv >= rows ? rows - 1 : fv;
                const long long q = (long long)fv * cols + fu;
                const float dv = depths[v * hw + q];
                if (dv <= 0.0f) continue;

                const float baseline = norm(rc.center - cams[v].center);
                const float disp_a = disparity(rc.f, baseline, dproj);
                const float disp_b = disparity(rc.f, baseline, dv);
                if (std::fabs(disp_a - disp_b) >= disp_thresh) continue;
                const float* nv = normals + (v * hw + q) * 3;
                Vec3 n2{nv[0], nv[1], nv[2]};
                if (angle_between(n2, n) >= normal_thresh) continue;

                const int bu = (int)u;
                const int bv = (int)w;
                Vec3 Xv = backproject(cams[v], (float)bu, (float)bv, dv);
                cX = cX + Xv;
                cN = cN + n2;
                if (colors) {
                    const float* cv = colors + (v * hw + q) * 3;
                    cC = cC + Vec3{cv[0], cv[1], cv[2]};
                }
                ++consistent;
            }

            if (consistent >= num_consistent) {
                const float inv = 1.0f / ((float)consistent + 1.0f);
                cX = cX * inv;
                cN = cN * inv;
                cC = cC * inv;
                if (cX.x != 0.0f && cX.y != 0.0f && cX.z != 0.0f) {
                    const long long idx = count.fetch_add(1);
                    if (idx < capacity) {
                        float* o = out + idx * 10;
                        o[0] = cX.x; o[1] = cX.y; o[2] = cX.z;
                        o[3] = cN.x; o[4] = cN.y; o[5] = cN.z;
                        o[6] = cC.x; o[7] = cC.y; o[8] = cC.z;
                        o[9] = (float)consistent;
                    }
                }
            }
        }
    }

    delete[] cams;
    long long total = count.load();
    return total < capacity ? total : capacity;
}

int fusion_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
