// Helpers shared by the port's CUDA kernels (plain C interface, loaded with
// ctypes by sfm_tpu_torch/_kernels.py). Every entry point launches on the
// stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstddef>

#define SFM_API extern "C" __attribute__((visibility("default")))

// Python's / jnp.remainder's float modulo: the result takes the divisor's sign.
__device__ __forceinline__ float sfm_pos_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

__device__ __forceinline__ int sfm_pos_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// (1 - f) * a + f * b, rounded after every operation (no FMA contraction),
// as the plain PyTorch twin evaluates it.
__device__ __forceinline__ float sfm_lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

// v clamped into [0, hi]: an index from outside never reads past its rows.
__device__ __forceinline__ int64_t sfm_clamp_index(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Block-wide sums of M floats per thread (warp shuffles, then the warps in a
// fixed order: deterministic); every thread gets the result. red holds
// NT / 32 x M floats; every thread of the block must call it.
template <int NT, int M>
__device__ __forceinline__ void sfm_block_sum(float* v, float (*red)[M]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[m] += __shfl_xor_sync(0xffffffffu, v[m], off);
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp][m] = v[m];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
    for (int k = 0; k < NT / 32; ++k) s += red[k][m];
    v[m] = s;
  }
  __syncthreads();
}

// epipolar.py::symmetric_epipolar_distance of one row (x, y) <-> (u, v)
// under the row-major F: lines F^T x2 in image 1 and F x1 in image 2.
__device__ __forceinline__ float sfm_sym_epipolar(const float* f, float x, float y, float u,
                                                  float v) {
  const float l10 = f[0] * u + f[3] * v + f[6];
  const float l11 = f[1] * u + f[4] * v + f[7];
  const float l12 = f[2] * u + f[5] * v + f[8];
  const float l20 = f[0] * x + f[1] * y + f[2];
  const float l21 = f[3] * x + f[4] * y + f[5];
  const float l22 = f[6] * x + f[7] * y + f[8];
  const float d1 = fabsf(l10 * x + l11 * y + l12) / fmaxf(sqrtf(l10 * l10 + l11 * l11), 1e-12f);
  const float d2 = fabsf(l20 * u + l21 * v + l22) / fmaxf(sqrtf(l20 * l20 + l21 * l21), 1e-12f);
  return 0.5f * (d1 + d2);
}

// ---- RANSAC selection shared by K2 (fmat_ransac.cu) and K6 (pnp_ransac.cu).
//
// ransac_select's rule: inliers are valid rows with error < threshold; the
// score is count - mean_inlier_error / max(threshold, 1e-6); the highest
// score wins and the first index wins a tie.
struct SfmCand {
  float score;
  int h;
  int count;
};

__device__ __forceinline__ float sfm_ransac_score(int count, float err_sum,
                                                  float thr) {
  return (float)count - (err_sum / (float)max(count, 1)) / fmaxf(thr, 1e-6f);
}

__device__ __forceinline__ SfmCand sfm_cand_max(const SfmCand& a,
                                                const SfmCand& b) {
  const bool b_wins = b.score > a.score || (b.score == a.score && b.h < a.h);
  return b_wins ? b : a;
}

// Block-wide winner of the threads' candidates (NT a multiple of 32); the
// result is valid in thread 0. Every thread of the block must call it.
template <int NT>
__device__ SfmCand sfm_block_best(SfmCand best) {
  __shared__ SfmCand warp_best[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    SfmCand o;
    o.score = __shfl_xor_sync(0xffffffffu, best.score, off);
    o.h = __shfl_xor_sync(0xffffffffu, best.h, off);
    o.count = __shfl_xor_sync(0xffffffffu, best.count, off);
    best = sfm_cand_max(best, o);
  }
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < NT / 32; ++i) best = sfm_cand_max(best, warp_best[i]);
  }
  return best;
}

// ---- DLT triangulation as sfm_tpu_torch/geometry/triangulation.py, shared by
// K7 (triangulate_tracks.cu) and K14 (seed_score.cu).
//
// Adds the two row-normalized DLT rows of pixel (x, y) under the 3x4 camera P
// to the 4x4 normal matrix A (A += q q^T per row).
__device__ __forceinline__ void sfm_dlt_add(const float* P, float x, float y, float A[4][4]) {
  float q[2][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q[0][k] = x * P[8 + k] - P[k];
    q[1][k] = y * P[8 + k] - P[4 + k];
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float nrm = fmaxf(
        sqrtf(q[m][0] * q[m][0] + q[m][1] * q[m][1] + q[m][2] * q[m][2] + q[m][3] * q[m][3]),
        1e-12f);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[m][k] /= nrm;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[i][j] += q[m][i] * q[m][j];
  }
}

// Smallest eigenvector of the 4x4 normal matrix (8 steps of inverse iteration
// with the adjugate of A + (1e-6 mean_eig + 1e-20) I, as
// utils/linalg.py::_smallest_eigvec_adjugate), dehomogenized as
// triangulation.py::_solve_dlt.
__device__ inline void sfm_solve_dlt(const float A[4][4], float X[3]) {
  const float mean = (A[0][0] + A[1][1] + A[2][2] + A[3][3]) / 4.f;
  float a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = A[i][j] + (i == j ? 1e-6f * mean + 1e-20f : 0.f);
  const float s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1];
  const float s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2];
  const float s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3];
  const float s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2];
  const float s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3];
  const float s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3];
  const float c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3];
  const float c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3];
  const float c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2];
  const float c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3];
  const float c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2];
  const float c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1];
  const float M[4][4] = {
      {a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3, -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
       a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3, -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3},
      {-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1, a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
       -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1, a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1},
      {a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0, -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
       a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0, -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0},
      {-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0, a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
       -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0, a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0}};
  float x[4] = {1.f, 1.001f, 1.002f, 1.003f};
  for (int it = 0; it < 8; ++it) {
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = M[i][0] * x[0] + M[i][1] * x[1] + M[i][2] * x[2] + M[i][3] * x[3];
    const float nrm = fmaxf(sqrtf(y[0] * y[0] + y[1] * y[1] + y[2] * y[2] + y[3] * y[3]), 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = y[i] / nrm;
  }
  const float w = fabsf(x[3]) < 1e-12f ? 1e-12f : x[3];
  X[0] = x[0] / w;
  X[1] = x[1] / w;
  X[2] = x[2] / w;
}

// ---- Pinhole projection as sfm_tpu_torch/geometry/projection.py::project:
// x_cam = R X + t, the depth clamped away from 0 by 1e-12, then
// u = fx * x / z + cx, v = fy * y / z + cy. Returns the depth.
__device__ __forceinline__ float sfm_project(const float* R, const float* t,
                                             const float* intr, float X0,
                                             float X1, float X2, float* u,
                                             float* v) {
  const float x = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
  const float y = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
  const float d = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
  const float z = fabsf(d) < 1e-12f ? 1e-12f : d;
  *u = intr[0] * x / z + intr[2];
  *v = intr[1] * y / z + intr[3];
  return d;
}
