// Two-view and rotation algebra shared by K2 (fmat_solve.cu), K6's refits
// (pnp_refine.cu), K14 (seed_score.cu) and K13's relative poses (relpose.cu).
//
// * the weighted normalized eight-point solve of one block's rows
//   (epipolar.py::eight_point): Hartley normalization and the 9x9 A^T A as
//   deterministic block reductions, then thread 0 runs smallest_eigvec (the
//   clamped Cholesky with its 1e-3 fallback shift, 8 steps of inverse
//   iteration), the rank-2 projection without an SVD, and the denormalization;
// * Horn's decomposition of E and recover_pose's four-way cheirality vote,
//   one thread per correspondence;
// * rodrigues with its three derivative matrices, rotation_to_rvec, and the
//   6x6 Cholesky solve of a Gauss-Newton step.
#pragma once

#include "sfm_common.cuh"

// ------------------------------------------------------------ small 3x3 algebra

__device__ __forceinline__ void sfm_cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void sfm_matmul3(const float A[3][3], const float B[3][3],
                                            float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

// utils/linalg.py::_smallest_eigvec_adjugate for n = 3: 8 steps of inverse
// iteration with adj(A + (1e-6 mean_eig + 1e-20) I), whose columns are the
// cross products of its rows.
__device__ inline void sfm_smallest_eigvec3(const float A[3][3], float x[3]) {
  const float mean = (A[0][0] + A[1][1] + A[2][2]) / 3.f;
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = A[i][j] + (i == j ? 1e-6f * mean + 1e-20f : 0.f);
  float c[3][3];  // c[k] = column k of the adjugate
  sfm_cross3(a[1], a[2], c[0]);
  sfm_cross3(a[2], a[0], c[1]);
  sfm_cross3(a[0], a[1], c[2]);
  x[0] = 1.f;
  x[1] = 1.001f;
  x[2] = 1.002f;
  for (int it = 0; it < 8; ++it) {
    float y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = c[0][i] * x[0] + c[1][i] * x[1] + c[2][i] * x[2];
    const float nrm = fmaxf(sqrtf(y[0] * y[0] + y[1] * y[1] + y[2] * y[2]), 1e-30f);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = y[i] / nrm;
  }
}

// R <- 1.5 R - 0.5 (R R^T) R, three times (epipolar.py::_orthonormalize).
__device__ inline void sfm_orthonormalize(float R[3][3]) {
  for (int it = 0; it < 3; ++it) {
    float RRt[3][3], M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RRt[i][j] = R[i][0] * R[j][0] + R[i][1] * R[j][1] + R[i][2] * R[j][2];
    sfm_matmul3(RRt, R, M);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = 1.5f * R[i][j] - 0.5f * M[i][j];
  }
}

// P = K [R | t] (3 x 4, row-major).
__device__ inline void sfm_camera(const float K[3][3], const float R[3][3], const float t[3],
                                  float P[12]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[4 * i + j] = K[i][0] * R[0][j] + K[i][1] * R[1][j] + K[i][2] * R[2][j];
    P[4 * i + 3] = K[i][0] * t[0] + K[i][1] * t[1] + K[i][2] * t[2];
  }
}

// Two-view DLT of one match under cameras P1, P2.
__device__ inline void sfm_triangulate2(const float P1[12], const float P2[12], const float p1[2],
                                        const float p2[2], float X[3]) {
  float A[4][4] = {{0.f}};
  sfm_dlt_add(P1, p1[0], p1[1], A);
  sfm_dlt_add(P2, p2[0], p2[1], A);
  sfm_solve_dlt(A, X);
}

// ------------------------------------------------------------ recover_pose

// epipolar.py::recover_pose for one block, one correspondence a thread:
// Horn's decomposition of E (normalized to Frobenius norm sqrt(2); t the null
// vector of En En^T, R = Cof(En) -+ [t]x En, each orthonormalized), then the
// cheirality of (R_k, +-t) from one triangulation per rotation. The counts are
// __syncthreads_count reductions of the threads with w set, and the first
// maximum wins (jnp.argmax's tie). Every thread of the block must call it;
// every thread gets R, t (the sign applied), its row's mask and the count.
__device__ inline void sfm_recover_pose(const float E[3][3], const float K[3][3],
                                        const float p1[2], const float p2[2], bool w,
                                        float R[3][3], float t[3], bool* mask, int* count) {
  float fro = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) fro += E[i / 3][i % 3] * E[i / 3][i % 3];
  const float scale = 1.41421356f / fmaxf(sqrtf(fro), 1e-12f);
  float En[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) En[i / 3][i % 3] = E[i / 3][i % 3] * scale;

  float EEt[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      EEt[i][j] = En[i][0] * En[j][0] + En[i][1] * En[j][1] + En[i][2] * En[j][2];
  sfm_smallest_eigvec3(EEt, tn);
  const float B[3][3] = {{0.f, -tn[2], tn[1]}, {tn[2], 0.f, -tn[0]}, {-tn[1], tn[0], 0.f}};
  float cof[3][3], BE[3][3], Rc[2][3][3];
  sfm_cross3(En[1], En[2], cof[0]);
  sfm_cross3(En[2], En[0], cof[1]);
  sfm_cross3(En[0], En[1], cof[2]);
  sfm_matmul3(B, En, BE);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    Rc[0][i / 3][i % 3] = cof[i / 3][i % 3] - BE[i / 3][i % 3];
    Rc[1][i / 3][i % 3] = cof[i / 3][i % 3] + BE[i / 3][i % 3];  // Cof(-En) - [t]x (-En)
  }
  sfm_orthonormalize(Rc[0]);
  sfm_orthonormalize(Rc[1]);

  const float I3[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  const float zero3[3] = {0.f, 0.f, 0.f};
  float P1[12], P2[12];
  sfm_camera(K, I3, zero3, P1);
  int counts[4];
  bool masks[4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    sfm_camera(K, Rc[k], tn, P2);
    float X[3];
    sfm_triangulate2(P1, P2, p1, p2, X);
    const float z1 = X[2];
    const float z2 = Rc[k][2][0] * X[0] + Rc[k][2][1] * X[1] + Rc[k][2][2] * X[2] + tn[2];
    masks[2 * k] = z1 > 0.f && z2 > 0.f;
    masks[2 * k + 1] = z1 < 0.f && z2 < 0.f;
    counts[2 * k] = __syncthreads_count(w && masks[2 * k]);
    counts[2 * k + 1] = __syncthreads_count(w && masks[2 * k + 1]);
  }
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (counts[k] > counts[best]) best = k;
  const float sgn = best % 2 ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = Rc[best / 2][i / 3][i % 3];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sgn * tn[i];
  *mask = masks[best] && w;
  *count = counts[best];
}

// ------------------------------------------------------------ eight-point

// Packed lower triangle of a symmetric matrix: entry (i, j), j <= i.
__device__ __forceinline__ constexpr int sfm_pk(int i, int j) { return i * (i + 1) / 2 + j; }

// One row of eight_point's design matrix (x2^T F x1 = a . vec(F)), times w,
// added to the packed A^T A.
__device__ __forceinline__ void sfm_add_design_row(float x1, float y1, float x2, float y2,
                                                   float w, float* A) {
  const float a[9] = {x2 * x1 * w, x2 * y1 * w, x2 * w, y2 * x1 * w, y2 * y1 * w,
                      y2 * w,      x1 * w,      y1 * w, w};
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[sfm_pk(i, j)] += a[i] * a[j];
}

// utils/linalg.py::_cholesky_clamped of the packed N x N A + shift I, column
// by column, written to L (which may be A itself: each entry of A is read
// before its place is written). Returns whether a pivot was nonpositive.
// N = 9: the eight-point normal matrices; N = 12: the DLT PnP's.
template <int N>
__device__ __forceinline__ bool sfm_cholesky_clamped(const float* A, float shift, float* L) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc += L[sfm_pk(j, k)] * L[sfm_pk(j, k)];
    const float s = (A[sfm_pk(j, j)] + shift) - acc;
    bad |= s <= 0.f;
    const float d = sqrtf(fmaxf(s, 1e-30f));
    L[sfm_pk(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float r = 0.f;
#pragma unroll
      for (int k = 0; k < j; ++k) r += L[sfm_pk(i, k)] * L[sfm_pk(j, k)];
      L[sfm_pk(i, j)] = (A[sfm_pk(i, j)] - r) / d;
    }
  }
  return bad;
}

// smallest_eigvec's iteration on the factor: x <- (L L^T)^-1 x, normalized,
// from x0 = 1 + 1e-3 * arange(N).
template <int N>
__device__ __forceinline__ void sfm_inverse_iterate(const float* L, int iters, float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 1.f + 1e-3f * (float)i;
  for (int it = 0; it < iters; ++it) {
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[sfm_pk(i, k)] * y[k];
      y[i] = s / L[sfm_pk(i, i)];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s -= L[sfm_pk(k, i)] * x[k];
      x[i] = s / L[sfm_pk(i, i)];
    }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) n2 += x[i] * x[i];
    const float nrm = fmaxf(sqrtf(n2), 1e-30f);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] /= nrm;
  }
}

// F = T2^T Fn T1 (T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]], given as
// (s, cx, cy)), then divided by max(||F||_F, 1e-12).
__device__ __forceinline__ void sfm_denormalize(const float* fn, const float* t1,
                                                const float* t2, float* F) {
  const float T1[9] = {t1[0], 0.f, -t1[0] * t1[1], 0.f, t1[0], -t1[0] * t1[2], 0.f, 0.f, 1.f};
  const float T2[9] = {t2[0], 0.f, -t2[0] * t2[1], 0.f, t2[0], -t2[0] * t2[2], 0.f, 0.f, 1.f};
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i * 3 + j] = fn[i * 3] * T1[j] + fn[i * 3 + 1] * T1[3 + j] + fn[i * 3 + 2] * T1[6 + j];
  float n2 = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      F[i * 3 + j] = T2[i] * M[j] + T2[3 + i] * M[3 + j] + T2[6 + i] * M[6 + j];
      n2 += F[i * 3 + j] * F[i * 3 + j];
    }
  const float nrm = fmaxf(sqrtf(n2), 1e-12f);
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] /= nrm;
}

// Rank 2 without an SVD: F <- F (I - v v^T), v the unit eigenvector of F^T F
// for its smallest eigenvalue. adj(F^T F) = det (F^T F)^-1 has v as its
// dominant eigenvector (as utils/linalg.py::_smallest_eigvec_adjugate uses
// it), and is still v v^T times lambda_1 lambda_2 when F is singular; 12
// renormalized squarings raise it to the power 4096, so its other directions
// shrink by (sigma_3 / sigma_2)^8192 and every column is a multiple of v; v is
// the column of largest norm. A rank-1 F has adj = 0 and is left as it is.
__device__ inline void sfm_rank2_project(float* f) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = f[i] * f[j] + f[3 + i] * f[3 + j] + f[6 + i] * f[6 + j];
  // adj(M)[:, j] = row (j+1) x row (j+2).
  float P[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* a = M + ((j + 1) % 3) * 3;
    const float* b = M + ((j + 2) % 3) * 3;
    P[0 * 3 + j] = a[1] * b[2] - a[2] * b[1];
    P[1 * 3 + j] = a[2] * b[0] - a[0] * b[2];
    P[2 * 3 + j] = a[0] * b[1] - a[1] * b[0];
  }
  for (int k = 0; k < 12; ++k) {
    float Q[9], mx = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Q[i * 3 + j] = P[i * 3] * P[j] + P[i * 3 + 1] * P[3 + j] + P[i * 3 + 2] * P[6 + j];
        mx = fmaxf(mx, fabsf(Q[i * 3 + j]));
      }
    mx = fmaxf(mx, 1e-30f);
#pragma unroll
    for (int e = 0; e < 9; ++e) P[e] = Q[e] / mx;
  }
  int jm = 0;
  float best = -1.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float n2 = P[j] * P[j] + P[3 + j] * P[3 + j] + P[6 + j] * P[6 + j];
    if (n2 > best) {
      best = n2;
      jm = j;
    }
  }
  const float nrm = fmaxf(sqrtf(best), 1e-30f);
  const float v[3] = {P[jm] / nrm, P[3 + jm] / nrm, P[6 + jm] / nrm};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fv = f[i * 3] * v[0] + f[i * 3 + 1] * v[1] + f[i * 3 + 2] * v[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) f[i * 3 + j] -= fv * v[j];
  }
}

// eight_point(pts1, pts2, weights=w) of the N rows (x1, y1, x2, y2, w) the
// block holds in shared memory: the weighted Hartley normalization and the
// weighted 9x9 A^T A as block reductions (sfm_block_sum, deterministic); then
// thread 0 runs smallest_eigvec (8 steps; the 1e-3 fallback shift when a
// pivot of the 1e-6 factor is nonpositive), sfm_rank2_project and the
// denormalization into F (shared, 9). red holds NT / 32 x 45 floats. Every
// thread of the block must call it; F is ready when it returns.
template <int NT>
__device__ void sfm_eight_point_block(const float* x1, const float* y1, const float* x2,
                                      const float* y2, const float* w, int N, float (*red)[45],
                                      float* F) {
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sum w, w x1, w y1, w x2, w y2
  for (int n = threadIdx.x; n < N; n += NT) {
    const float wn = w[n];
    acc[0] += wn;
    acc[1] += x1[n] * wn;
    acc[2] += y1[n] * wn;
    acc[3] += x2[n] * wn;
    acc[4] += y2[n] * wn;
  }
  sfm_block_sum<NT, 5>(acc, reinterpret_cast<float(*)[5]>(&red[0][0]));
  const float wsum = fmaxf(acc[0], 1e-12f);
  const float c[4] = {acc[1] / wsum, acc[2] / wsum, acc[3] / wsum, acc[4] / wsum};

  float md[2] = {0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += NT) {
    const float dx1 = x1[n] - c[0], dy1 = y1[n] - c[1];
    const float dx2 = x2[n] - c[2], dy2 = y2[n] - c[3];
    md[0] += sqrtf(dx1 * dx1 + dy1 * dy1) * w[n];
    md[1] += sqrtf(dx2 * dx2 + dy2 * dy2) * w[n];
  }
  sfm_block_sum<NT, 2>(md, reinterpret_cast<float(*)[2]>(&red[0][0]));
  const float s1 = 1.41421356237309515f / fmaxf(md[0] / wsum, 1e-12f);
  const float s2 = 1.41421356237309515f / fmaxf(md[1] / wsum, 1e-12f);

  float A[45];
#pragma unroll
  for (int e = 0; e < 45; ++e) A[e] = 0.f;
  for (int n = threadIdx.x; n < N; n += NT) {
    if (w[n] == 0.f) continue;
    sfm_add_design_row((x1[n] - c[0]) * s1, (y1[n] - c[1]) * s1, (x2[n] - c[2]) * s2,
                       (y2[n] - c[3]) * s2, w[n], A);
  }
  sfm_block_sum<NT, 45>(A, red);

  if (threadIdx.x == 0) {
    float tr = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) tr += A[sfm_pk(i, i)];
    const float mean = tr / 9.f;
    float L[45];
    if (sfm_cholesky_clamped<9>(A, 1e-6f * mean + 1e-20f, L))
      sfm_cholesky_clamped<9>(A, 1e-3f * mean + 1e-20f, L);
    float f[9];
    sfm_inverse_iterate<9>(L, 8, f);
    sfm_rank2_project(f);
    const float t1[3] = {s1, c[0], c[1]}, t2[3] = {s2, c[2], c[3]};
    sfm_denormalize(f, t1, t2, F);
  }
  __syncthreads();
}

// ------------------------------------------------------------ a warp's divisions
// An IEEE division's slow-path branch keeps a thread's independent divisions
// from overlapping. A warp that runs one serial solve in every lane (the same
// operations, the same bits) spreads such a step's divisions over its lanes.

constexpr unsigned SFM_FULL_MASK = 0xffffffffu;

// x[lane] of x[0..n), n <= MAXV, without a local array (lanes >= n get x[0]).
template <int MAXV>
__device__ __forceinline__ float sfm_lane_pick(const float* x, int n, int lane) {
  float v = x[0];
#pragma unroll
  for (int i = 1; i < MAXV; ++i) v = (i < n && lane == i) ? x[i] : v;
  return v;
}

// x[i] = x[i] / d for i < n: lane i divides, every lane gets all of them.
template <int n>
__device__ __forceinline__ void sfm_warp_divide(float* x, float d, int lane) {
  const float q = sfm_lane_pick<n>(x, n, lane) / d;
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = __shfl_sync(SFM_FULL_MASK, q, i);
}

// ------------------------------------------------------------ rotations, GN

// R = I + a K + b K^2 (rotations.py::rodrigues, row-major 9) and, when
// dR != nullptr, dR[j] = dR / d rvec_j (forward mode, the theta^2 < 1e-8
// Taylor branch included, as jax.jacfwd differentiates it).
__device__ inline void sfm_rodrigues_d(const float* w, float* R, float (*dR)[9]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  float a, b, da, db;  // da, db: d/d(theta^2)
  if (small) {
    a = 1.f - th2 / 6.f;
    b = 0.5f - th2 / 24.f;
    da = -1.f / 6.f;
    db = -1.f / 24.f;
  } else {
    const float th = sqrtf(th2);
    const float s = sinf(th), c = cosf(th);
    a = s / th;
    b = (1.f - c) / th2;
    da = (th * c - s) / (2.f * th2 * th);
    db = (th * s - 2.f * (1.f - c)) / (2.f * th2 * th2);
  }
  const float K[9] = {0.f, -w[2], w[1], w[2], 0.f, -w[0], -w[1], w[0], 0.f};
  float K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
#pragma unroll
  for (int e = 0; e < 9; ++e) R[e] = (e % 4 == 0 ? 1.f : 0.f) + a * K[e] + b * K2[e];
  if (dR == nullptr) return;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // dK = skew(e_j); d(K^2) = dK K + K dK.
    float dK[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j == 0) { dK[5] = -1.f; dK[7] = 1.f; }
    if (j == 1) { dK[2] = 1.f; dK[6] = -1.f; }
    if (j == 2) { dK[1] = -1.f; dK[3] = 1.f; }
    const float dth2 = 2.f * w[j];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float dK2 = 0.f;
#pragma unroll
        for (int m = 0; m < 3; ++m) dK2 += dK[r * 3 + m] * K[m * 3 + c] + K[r * 3 + m] * dK[m * 3 + c];
        dR[j][r * 3 + c] = da * dth2 * K[r * 3 + c] + a * dK[r * 3 + c] +
                           db * dth2 * K2[r * 3 + c] + b * dK2;
      }
  }
}

// rotations.py::rotation_to_rvec (row-major 9): generic, theta -> 0 and
// theta -> pi.
__device__ inline void sfm_rotation_to_rvec(const float* R, float* out) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_t = fminf(fmaxf((tr - 1.f) * 0.5f, -1.f), 1.f);
  const float theta = acosf(cos_t);
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  if (theta < 1e-5f) {
    for (int k = 0; k < 3; ++k) out[k] = 0.5f * v[k];
    return;
  }
  if (theta > (float)(3.14159265358979323846 - 1e-3)) {
    float ax[3];
    for (int k = 0; k < 3; ++k) ax[k] = sqrtf(fmaxf((R[k * 4] + 1.f) * 0.5f, 0.f));
    int im = 0;
    if (ax[1] > ax[im]) im = 1;
    if (ax[2] > ax[im]) im = 2;
    auto sgn = [](float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); };
    const float s01 = sgn(R[1] + R[3]), s02 = sgn(R[2] + R[6]), s12 = sgn(R[5] + R[7]);
    const float sraw[3] = {im == 1 ? s01 : s02, im == 0 ? s01 : s12, im == 0 ? s02 : s12};
    float n2 = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float s = k == im ? 1.f : (sraw[k] == 0.f ? 1.f : sraw[k]);
      ax[k] *= s;
      n2 += ax[k] * ax[k];
    }
    const float n = fmaxf(sqrtf(n2), 1e-12f);
    for (int k = 0; k < 3; ++k) out[k] = ax[k] / n * theta;
    return;
  }
  const float n = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-12f);
  for (int k = 0; k < 3; ++k) out[k] = v[k] / n * theta;
}

// (A + shift I) x = g by a 6x6 Cholesky; A given by its upper triangle (21,
// row-major). clamp: each pivot is sqrt(max(s, 1e-30)) (utils/linalg.py::
// _chol_unrolled); without it a nonpositive pivot gives NaN, for a caller's
// finite guard.
__device__ inline void sfm_solve6(const float* A21, const float* g, float* x, float shift,
                                  bool clamp) {
  float L[6][6];
  int e = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) {
      L[j][i] = A21[e++] + (i == j ? shift : 0.f);  // lower triangle of A + shift I
    }
  for (int j = 0; j < 6; ++j) {
    float s = L[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(clamp ? fmaxf(s, 1e-30f) : s);
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float r = L[i][j];
      for (int k = 0; k < j; ++k) r -= L[i][k] * L[j][k];
      L[i][j] = r / d;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}
