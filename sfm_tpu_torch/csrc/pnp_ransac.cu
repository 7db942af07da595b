// Kernel K6: P3P-RANSAC for a batch of PnP candidates (two entries).
//
// Replaces sfm_tpu/estimators/pnp.py::pnp_ransac_batch / pnp_ransac on the P3P
// path (sample_size 3): the vmapped _p3p_candidates (:114, Durand-Kerner quartic
// :94), then the (B, hypotheses, N) projection-error matrix with cheirality and
// ransac_select. There the error matrix (8192 x 2048 f32 = 64 MB per candidate)
// goes through device memory; here each hypothesis's count and error sum stay in
// registers.
//
// Entry A, sfm_p3p_solve: one thread per (candidate, sample) runs Grunert's P3P
// exactly as pnp.py::_p3p_candidates does (same quartic coefficients, 30
// Durand-Kerner iterations in complex f32, same masks) and writes 4 (R, t, ok).
// Entry B, sfm_pnp_score_select: blocks of 256 hypotheses of one candidate; the
// candidate's N correspondences sit in shared memory (6 floats a row), one thread
// walks them for its hypothesis, a block argmax (sfm_common.cuh, shared with K2)
// writes one partial winner per block, and a second small kernel picks each
// candidate's winner over its blocks (first index on ties).
//
// What bounds it on the H100: f32 arithmetic and the one division/sqrt per
// (hypothesis, point): 8 x 8192 x 2048 = 134M projections (~25 FLOP each, 3.4
// GFLOP) per registration round at the default config; inputs are ~50 KB per
// candidate, so memory is no limit. 8 x 32 = 256 blocks fill the 132 SMs.
#include <climits>

#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr float kEps = 1e-12f;

struct cf {
  float x, y;
};
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ cf cdiv(cf a, cf b) {  // Smith's algorithm
  if (fabsf(b.x) >= fabsf(b.y)) {
    const float r = b.y / b.x, d = b.x + b.y * r;
    return {(a.x + a.y * r) / d, (a.y - a.x * r) / d};
  }
  const float r = b.x / b.y, d = b.y + b.x * r;
  return {(a.x * r + a.y) / d, (a.y * r - a.x) / d};
}
__device__ __forceinline__ float cabs_(cf a) { return hypotf(a.x, a.y); }

__device__ __forceinline__ void normalize3(float* v) {
  const float n = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), kEps);
  v[0] /= n;
  v[1] /= n;
  v[2] /= n;
}

// Orthonormal frame of 3 points Q (rows): T's columns are e1, e2, e3.
__device__ bool triad(const float Q[3][3], float T[3][3]) {
  float e1[3], e2[3], e3[3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = Q[1][k] - Q[0][k];
    e2[k] = Q[2][k] - Q[0][k];
  }
  normalize3(e1);
  const float d = e2[0] * e1[0] + e2[1] * e1[1] + e2[2] * e1[2];
  for (int k = 0; k < 3; ++k) e2[k] -= d * e1[k];
  const float n2 = sqrtf(e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]);
  for (int k = 0; k < 3; ++k) e2[k] /= fmaxf(n2, kEps);
  e3[0] = e1[1] * e2[2] - e1[2] * e2[1];
  e3[1] = e1[2] * e2[0] - e1[0] * e2[2];
  e3[2] = e1[0] * e2[1] - e1[1] * e2[0];
  for (int k = 0; k < 3; ++k) {
    T[k][0] = e1[k];
    T[k][1] = e2[k];
    T[k][2] = e3[k];
  }
  return n2 > 1e-9f;
}

__global__ void __launch_bounds__(NT) p3p_kernel(const float* __restrict__ s3,
                                                 const float* __restrict__ s2n,
                                                 int n, float* __restrict__ Rs,
                                                 float* __restrict__ ts,
                                                 uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float P[3][3], f[3][3];
  for (int r = 0; r < 3; ++r) {
    for (int k = 0; k < 3; ++k) P[r][k] = s3[(size_t)i * 9 + r * 3 + k];
    f[r][0] = s2n[(size_t)i * 6 + r * 2];
    f[r][1] = s2n[(size_t)i * 6 + r * 2 + 1];
    f[r][2] = 1.f;
    normalize3(f[r]);
  }
  auto sq = [](const float* a, const float* b) {
    const float x = a[0] - b[0], y = a[1] - b[1], z = a[2] - b[2];
    return x * x + y * y + z * z;
  };
  auto dot = [](const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  };
  const float a2 = sq(P[1], P[2]);
  const float b2 = fmaxf(sq(P[0], P[2]), kEps);
  const float c2 = sq(P[0], P[1]);
  const float cos_a = dot(f[1], f[2]), cos_b = dot(f[0], f[2]), cos_c = dot(f[0], f[1]);
  const float q = (a2 - c2) / b2;
  const float A4 = (q - 1.f) * (q - 1.f) - 4.f * c2 / b2 * cos_a * cos_a;
  const float A3 = 4.f * (q * (1.f - q) * cos_b - (1.f - (a2 + c2) / b2) * cos_a * cos_c +
                          2.f * c2 / b2 * cos_a * cos_a * cos_b);
  const float A2 = 2.f * (q * q - 1.f + 2.f * q * q * cos_b * cos_b +
                          2.f * (b2 - c2) / b2 * cos_a * cos_a -
                          4.f * (a2 + c2) / b2 * cos_a * cos_b * cos_c +
                          2.f * (b2 - a2) / b2 * cos_c * cos_c);
  const float A1 = 4.f * (-q * (1.f + q) * cos_b + 2.f * a2 / b2 * cos_c * cos_c * cos_b -
                          (1.f - (a2 + c2) / b2) * cos_a * cos_c);
  const float A0 = (1.f + q) * (1.f + q) - 4.f * a2 / b2 * cos_c * cos_c;

  // Durand-Kerner on the monic quartic.
  const float scale = fabsf(A4) > 1e-12f ? A4 : (A4 >= 0.f ? 1e-12f : -1e-12f);
  const cf a3{A3 / scale, 0.f}, a2c{A2 / scale, 0.f}, a1{A1 / scale, 0.f},
      a0{A0 / scale, 0.f};
  const float rad = powf(1.f + fabsf(a0.x), 0.25f);
  cf z[4] = {{rad, 0.f}, {0.4f * rad, 0.9f * rad}, {-0.65f * rad, 0.72f * rad},
             {-0.908f * rad, -0.297f * rad}};
  for (int it = 0; it < 30; ++it) {
    cf zn[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cf den{1.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const cf d = j == k ? cf{1.f, 0.f} : csub(z[k], z[j]);
        den = cmul(den, d);
      }
      const cf p = cadd(cmul(cadd(cmul(cadd(cmul(cadd(z[k], a3), z[k]), a2c), z[k]), a1),
                             z[k]),
                        a0);
      if (!(cabs_(den) > 1e-20f)) den = cf{1e-20f, 0.f};
      zn[k] = csub(z[k], cdiv(p, den));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) z[k] = zn[k];
  }

  float Tw[3][3];
  const bool w_ok = triad(P, Tw);
  for (int k = 0; k < 4; ++k) {
    const float v = z[k].x;
    bool ok = fabsf(z[k].y) < 1e-4f * (1.f + fabsf(v)) && v > kEps;
    const float num = (-1.f + q) * v * v - 2.f * q * cos_b * v + 1.f + q;
    const float den = 2.f * (cos_c - v * cos_a);
    const float u = num / (fabsf(den) > 1e-9f ? den : 1e-9f);
    const float s = 1.f + v * v - 2.f * v * cos_b;
    ok = ok && u > kEps && s > kEps && fabsf(den) > 1e-9f;
    const float d1 = sqrtf(b2 / fmaxf(s, kEps));
    float Pc[3][3];
    for (int c = 0; c < 3; ++c) {
      Pc[0][c] = d1 * f[0][c];
      Pc[1][c] = (u * d1) * f[1][c];
      Pc[2][c] = (v * d1) * f[2][c];
    }
    float Tc[3][3], R[3][3], t[3];
    const bool c_ok = triad(Pc, Tc);
    bool finite = true;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        R[r][c] = Tc[r][0] * Tw[c][0] + Tc[r][1] * Tw[c][1] + Tc[r][2] * Tw[c][2];
        finite = finite && isfinite(R[r][c]);
      }
    for (int r = 0; r < 3; ++r) {
      t[r] = Pc[0][r] - (R[r][0] * P[0][0] + R[r][1] * P[0][1] + R[r][2] * P[0][2]);
      finite = finite && isfinite(t[r]);
    }
    ok = ok && c_ok && w_ok && finite;
    float* Ro = Rs + ((size_t)i * 4 + k) * 9;
    float* to = ts + ((size_t)i * 4 + k) * 3;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Ro[r * 3 + c] = ok ? R[r][c] : (r == c ? 1.f : 0.f);
      to[r] = ok ? t[r] : 0.f;
    }
    ok_out[(size_t)i * 4 + k] = ok;
  }
}

__global__ void __launch_bounds__(NT) pnp_score_kernel(
    const float* __restrict__ Rs, const float* __restrict__ ts,
    const uint8_t* __restrict__ cand_ok, const float* __restrict__ pts3d,
    const float* __restrict__ pts2d, const uint8_t* __restrict__ valid,
    const float* __restrict__ intr, int H, int N, float thr,
    float* __restrict__ part) {
  extern __shared__ float sm[];  // 6 floats a row: X, Y, Z, u, v, valid
  const int b = blockIdx.y;
  for (int n = threadIdx.x; n < N; n += NT) {
    const size_t o = (size_t)b * N + n;
    sm[6 * n + 0] = pts3d[3 * o];
    sm[6 * n + 1] = pts3d[3 * o + 1];
    sm[6 * n + 2] = pts3d[3 * o + 2];
    sm[6 * n + 3] = pts2d[2 * o];
    sm[6 * n + 4] = pts2d[2 * o + 1];
    sm[6 * n + 5] = valid[o] ? 1.f : 0.f;
  }
  __syncthreads();
  float k4[4];
  for (int k = 0; k < 4; ++k) k4[k] = intr[k];

  SfmCand best{-INFINITY, INT_MAX, 0};
  const int h = blockIdx.x * NT + threadIdx.x;
  if (h < H) {
    const size_t bh = (size_t)b * H + h;
    float R[9], t[3];
    for (int k = 0; k < 9; ++k) R[k] = Rs[bh * 9 + k];
    for (int k = 0; k < 3; ++k) t[k] = ts[bh * 3 + k];
    const bool hok = cand_ok[bh] != 0;
    int count = 0;
    float err_sum = 0.f;
    if (hok) {
      for (int n = 0; n < N; ++n) {
        const float* row = sm + 6 * n;
        if (row[5] == 0.f) continue;
        float u, v;
        const float depth = sfm_project(R, t, k4, row[0], row[1], row[2], &u, &v);
        const float du = u - row[3], dv = v - row[4];
        const float err = sqrtf(du * du + dv * dv);
        if (depth > 0.f && err < thr) {
          ++count;
          err_sum += err;
        }
      }
    }
    best = SfmCand{sfm_ransac_score(count, err_sum, thr), h, count};
  }
  best = sfm_block_best<NT>(best);
  if (threadIdx.x == 0) {
    float* p = part + ((size_t)b * gridDim.x + blockIdx.x) * 3;
    p[0] = best.score;
    p[1] = __int_as_float(best.h);
    p[2] = __int_as_float(best.count);
  }
}

__global__ void __launch_bounds__(NT) pnp_select_kernel(const float* __restrict__ part,
                                                        int nblk, int* __restrict__ best_out,
                                                        int* __restrict__ count_out) {
  const int b = blockIdx.x;
  SfmCand best{-INFINITY, INT_MAX, 0};
  for (int k = threadIdx.x; k < nblk; k += NT) {
    const float* p = part + ((size_t)b * nblk + k) * 3;
    best = sfm_cand_max(best, SfmCand{p[0], __float_as_int(p[1]), __float_as_int(p[2])});
  }
  best = sfm_block_best<NT>(best);
  if (threadIdx.x == 0) {
    best_out[b] = best.h == INT_MAX ? 0 : best.h;
    count_out[b] = best.count;
  }
}

}  // namespace

SFM_API int sfm_p3p_solve(const void* s3, const void* s2n, int n, void* Rs,
                          void* ts, void* ok, void* stream) {
  if (n > 0) {
    p3p_kernel<<<(n + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s3), static_cast<const float*>(s2n), n,
        static_cast<float*>(Rs), static_cast<float*>(ts), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_pnp_score_select(const void* Rs, const void* ts, const void* cand_ok,
                                 const void* pts3d, const void* pts2d,
                                 const void* valid, const void* intr, int B, int H,
                                 int N, float thr, void* part, void* best,
                                 void* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (H + NT - 1) / NT;
  const size_t smem = (size_t)N * 6 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pnp_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pnp_score_kernel<<<dim3(nblk, B), NT, smem, st>>>(
      static_cast<const float*>(Rs), static_cast<const float*>(ts),
      static_cast<const uint8_t*>(cand_ok), static_cast<const float*>(pts3d),
      static_cast<const float*>(pts2d), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(intr), H, N, thr, static_cast<float*>(part));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pnp_select_kernel<<<B, NT, 0, st>>>(static_cast<const float*>(part), nblk,
                                      static_cast<int*>(best), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
