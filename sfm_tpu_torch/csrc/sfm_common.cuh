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

// Block-wide sums of M floats (or doubles) per thread (warp shuffles, then the
// warps in a fixed order: deterministic); every thread gets the result. red
// holds NT / 32 x M values; every thread of the block must call it.
template <int NT, int M, typename T>
__device__ __forceinline__ void sfm_block_sum(T* v, T (*red)[M]) {
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
    T s = T(0);
    for (int k = 0; k < NT / 32; ++k) s += red[k][m];
    v[m] = s;
  }
  __syncthreads();
}

// ---- Order-free sums ------------------------------------------------------
// Float atomics add in another order, and so round differently, on every run:
// a model built on such sums is not repeatable, and an incremental engine
// turns last-bit differences into other registrations. A sum that many threads
// scatter into is kept instead as a 64-bit integer of x * 2^sh: integer
// addition is associative, so every order gives the same bits, and the sum is
// rounded to float once at the end. sh comes from a bound B on the sum of the
// terms' magnitudes (B < 2^61 - sh, so the integer cannot overflow); the
// resolution B * 2^-61 is far below float rounding. Where no a-priori bound
// exists, a first pass takes each target's largest |term| with an atomic max
// (order-free as well) and B = max * (number of terms).

constexpr int SFM_FX_BAD = -100000;  // the shift of a non-finite bound

// Largest |x| of a target, as the bits of a non-negative float (they order as
// the floats do; NaN above inf).
__device__ __forceinline__ void sfm_fx_max(unsigned int* m, float x) {
  atomicMax(m, __float_as_uint(fabsf(x)));
}

// Shift for a sum whose terms' magnitudes add up to at most `bound`.
__device__ __forceinline__ int sfm_fx_shift(double bound) {
  if (!(bound <= 1e300)) return SFM_FX_BAD;  // inf or NaN terms
  int e = 0;
  frexp(bound, &e);  // bound < 2^e (e = 0 for bound = 0)
  return 61 - e;
}

__device__ __forceinline__ long long sfm_fx_of(float x, int sh) {
  return __double2ll_rn(ldexp((double)x, sh));
}

// The sum (NaN for a non-finite bound).
__device__ __forceinline__ double sfm_fx_value(unsigned long long acc, int sh) {
  if (sh == SFM_FX_BAD) return __longlong_as_double(0x7ff8000000000000ll);
  return ldexp(static_cast<double>(static_cast<long long>(acc)), -sh);
}

// ---- Order-free sums at the f64 island's precision ---------------------------
// K8-K11 are templated on the scalar type of the normal-equation island:
// float, or double with BAConfig.f64_normal_equations. One 64-bit word keeps
// about 61 - log2(terms) bits of a target's bound (~41 at 10^6 rows), fewer
// than f64's 53, and the island exists to keep the small terms an f32 sum
// loses. So a double target takes two words: x * 2^sh with sh = 93 - e
// (bound < 2^e) is split into hi = floor(x * 2^(sh - 32)) (|hi| < 2^61) and
// lo = its 32 bits below that (an integer in [0, 2^32]); the hi words and the
// lo words are summed apart, each with 64-bit integer atomics (any order, the
// same bits; the lo sum cannot overflow below 2^32 terms), and the carry is
// taken once at the end, where the two are joined and rounded to double. A
// term keeps 93 bits below the bound, so the sum is the exact sum of the
// double terms to within one rounding. Chosen over a deterministic
// segmented sum in a fixed order: the scatter kernels keep their layout (the
// same atomics, two words instead of one), where a fixed order would need
// every target's terms sorted or walked per camera. A target's words lie n
// apart: hi at i, lo at n + i.
template <typename T>
struct SfmFx;
template <>
struct SfmFx<float> {
  static constexpr int WORDS = 1;
  static constexpr int TOP = 61;
};
template <>
struct SfmFx<double> {
  static constexpr int WORDS = 2;
  static constexpr int TOP = 93;
};

// sfm_fx_shift for a float (one word) or a double (two words) target.
template <typename T>
__device__ __forceinline__ int sfm_fx_shift_t(double bound) {
  if (!(bound <= 1e300)) return SFM_FX_BAD;
  int e = 0;
  frexp(bound, &e);
  return SfmFx<T>::TOP - e;
}

// The shift of target i whose terms, at most `count` of them, are at most
// gmax[i] each (float bits, the two-pass sums' first pass).
template <typename T>
__device__ __forceinline__ int sfm_fx_max_shift(const unsigned int* gmax, int i, double count) {
  return sfm_fx_shift_t<T>((double)__uint_as_float(gmax[i]) * count);
}

// |x| as the bits of a non-negative float, rounded up (a bound).
__device__ __forceinline__ unsigned int sfm_fx_mag(float x) { return __float_as_uint(fabsf(x)); }
__device__ __forceinline__ unsigned int sfm_fx_mag(double x) {
  return __float_as_uint(__double2float_ru(fabs(x)));
}

// A term's words: from v = x 2^sh (already scaled), or from x at shift sh.
struct SfmFxQ {
  long long hi, lo;
};
template <typename T>
__device__ __forceinline__ SfmFxQ sfm_fx_words(double v) {
  if (SfmFx<T>::WORDS == 1) return {__double2ll_rn(v), 0};
  const double y = v * 0x1p-32;  // exact: a power of two
  const double h = floor(y);
  return {__double2ll_rn(h), __double2ll_rn((y - h) * 0x1p32)};
}
__device__ __forceinline__ SfmFxQ sfm_fx_q(float x, int sh) { return {sfm_fx_of(x, sh), 0}; }
__device__ __forceinline__ SfmFxQ sfm_fx_q(double x, int sh) {
  return sfm_fx_words<double>(ldexp(x, sh));
}

// The words q added to target i of n (words at i and n + i).
template <typename T>
__device__ __forceinline__ void sfm_fx_add_q(unsigned long long* acc, size_t n, size_t i,
                                             const SfmFxQ& q) {
  if (q.hi != 0) atomicAdd(&acc[i], static_cast<unsigned long long>(q.hi));
  if (SfmFx<T>::WORDS == 2 && q.lo != 0) atomicAdd(&acc[n + i], static_cast<unsigned long long>(q.lo));
}

// x added to target i of n at shift sh.
template <typename T>
__device__ __forceinline__ void sfm_fx_add_t(unsigned long long* acc, size_t n, size_t i, T x,
                                             int sh) {
  if (sh == SFM_FX_BAD) return;
  sfm_fx_add_q<T>(acc, n, i, sfm_fx_q(x, sh));
}

// The two words joined (the carry of the lo sum taken here) and rounded.
__device__ __forceinline__ double sfm_fx_value2(unsigned long long hi, unsigned long long lo,
                                                int sh) {
  if (sh == SFM_FX_BAD) return __longlong_as_double(0x7ff8000000000000ll);
  const long long top = static_cast<long long>(hi) + static_cast<long long>(lo >> 32);
  const double a = (double)top;
  const long long err = top - static_cast<long long>(a);  // what rounding top dropped
  return ldexp(a, 32 - sh) +
         (ldexp((double)err, 32 - sh) + ldexp((double)(lo & 0xffffffffull), -sh));
}

template <typename T>
__device__ __forceinline__ double sfm_fx_value_t(const unsigned long long* acc, size_t n,
                                                 size_t i, int sh) {
  if (SfmFx<T>::WORDS == 1) return sfm_fx_value(acc[i], sh);
  return sfm_fx_value2(acc[i], acc[n + i], sh);
}

// A block's staging copy of a two-pass order-free sum over n targets, in
// shared memory (WORDS x n x 8 bytes): pass MAX keeps each target's largest
// |term| (uint bits), pass ADD its fixed-point sum. Zero it, __syncthreads,
// put terms, __syncthreads, flush into the global copy.
template <typename T>
__device__ __forceinline__ void sfm_fx_stage_zero(unsigned long long* s, int n) {
  for (int i = threadIdx.x; i < SfmFx<T>::WORDS * n; i += blockDim.x) s[i] = 0ull;
}

// A thread's own running part of one target: ADD keeps its terms' integer
// sums, MAX their largest |term|. sfm_fx_put_warp then combines the warp's
// parts (any order: the same result) and stages them with one atomic a word.
struct SfmFxPart {
  long long q = 0, lo = 0;
  unsigned int b = 0u;
};

template <typename T, bool ADD>
__device__ __forceinline__ void sfm_fx_part(SfmFxPart& part, T x, int sh) {
  if (ADD) {
    if (sh != SFM_FX_BAD) {
      const SfmFxQ q = sfm_fx_q(x, sh);
      part.q += q.hi;
      part.lo += q.lo;
    }
  } else {
    part.b = max(part.b, sfm_fx_mag(x));
  }
}

// All 32 lanes must call it.
template <typename T, bool ADD>
__device__ __forceinline__ void sfm_fx_put_warp(unsigned long long* s, int n, int i,
                                                const SfmFxPart& part) {
  if (ADD) {
    long long q = part.q, lo = part.lo;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q += __shfl_xor_sync(0xffffffffu, q, off);
      if (SfmFx<T>::WORDS == 2) lo += __shfl_xor_sync(0xffffffffu, lo, off);
    }
    if (threadIdx.x % 32 == 0) {
      if (q != 0) atomicAdd(&s[i], static_cast<unsigned long long>(q));
      if (SfmFx<T>::WORDS == 2 && lo != 0) atomicAdd(&s[n + i], static_cast<unsigned long long>(lo));
    }
  } else {
    const unsigned int b = __reduce_max_sync(0xffffffffu, part.b);
    if (threadIdx.x % 32 == 0 && b != 0u) atomicMax(reinterpret_cast<unsigned int*>(s) + i, b);
  }
}

// Global copies: MAX into n uint32 (gmax), ADD into WORDS x n uint64 (gacc).
template <typename T, bool ADD>
__device__ __forceinline__ void sfm_fx_flush(const unsigned long long* s, int n,
                                             unsigned int* __restrict__ gmax,
                                             unsigned long long* __restrict__ gacc) {
  const int m = ADD ? SfmFx<T>::WORDS * n : n;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (ADD) {
      if (s[i] != 0ull) atomicAdd(&gacc[i], s[i]);
    } else {
      const unsigned int b = reinterpret_cast<const unsigned int*>(s)[i];
      if (b != 0u) atomicMax(&gmax[i], b);
    }
  }
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
// K7 (triangulate_tracks.cu) and, through sfm_geom.cuh's two-view DLT, K13
// and K14.
//
// The two row-normalized DLT rows q of pixel (x, y) under the 3x4 camera P.
__device__ __forceinline__ void sfm_dlt_rows(const float* P, float x, float y, float q[2][4]) {
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
  }
}

// The 4x4 normal matrix A += q q^T for both rows, the first row first.
__device__ __forceinline__ void sfm_dlt_accumulate(const float q[2][4], float A[4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[i][j] += q[m][i] * q[m][j];
}

// Adds the two row-normalized DLT rows of pixel (x, y) under the 3x4 camera P
// to the 4x4 normal matrix A (A += q q^T per row).
__device__ __forceinline__ void sfm_dlt_add(const float* P, float x, float y, float A[4][4]) {
  float q[2][4];
  sfm_dlt_rows(P, x, y, q);
  sfm_dlt_accumulate(q, A);
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
