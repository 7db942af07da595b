// Kernel K6, DLT branch: the hypotheses of PnP-RANSAC at pnp.sample_size != 3.
//
// Replaces sfm_tpu/estimators/pnp.py::pnp_ransac_batch's DLT branch (:308-319):
// the vmapped pnp_dlt (:27-91, with null_fallback=False) on each sample of
// `sample_size` correspondences (6 or more determine P; the reference takes
// any size but 3 here, and so does this kernel), then two _gn_sample_step s
// (:212-224) on the same sample. XLA ran it as batched (2S x 12) systems, a batched
// 12 x 12 inverse iteration, batched 3x3 algebra and a (2S x 6) forward-mode
// Jacobian per hypothesis, each through device memory.
//
// Design: one thread per (candidate, hypothesis), everything in registers
// (local memory where they spill) in one launch:
//  1. gather the sample's rows by the injected indices; stream its 2S DLT rows
//     [X 1 | 0 | -x (X 1)] and [0 | X 1 | -y (X 1)], each divided by
//     max(|row|, 1e-12), into the packed lower triangle of the 12 x 12 normal
//     matrix (78 floats), so any sample size runs and none is capped;
//  2. smallest_eigvec without the fallback tier: the clamped Cholesky of
//     A + (1e-6 tr(A) / 12 + 1e-20) I and 8 steps of inverse iteration
//     (sfm_geom.cuh, the eight-point solver's code at N = 12);
//  3. decompose P and -P: 12 Newton-Schulz steps X <- 1.5 X - 0.5 X X^T X from
//     M / |M|_F, the det < 0 flip X (I - 2 v v^T) with v the smallest
//     eigenvector of M^T M (3x3 adjugate iteration), t = p4 3 / trace(X^T M),
//     and the sign whose mean sample depth is the larger;
//  4. two Gauss-Newton steps from rotation_to_rvec(R): per sample row the
//     residual of the pinhole projection and its 6 forward-mode tangents
//     through rodrigues (sfm_rodrigues_d), summed into J^T J (21) and J^T r (6),
//     then (J^T J + 1e-4 I) delta = J^T r by a 6x6 Cholesky with clamped pivots
//     (the reference and the twin use LU: the same SPD system, another
//     rounding); params -= delta;
//  5. R = rodrigues(rvec), t.
// The sums run in row order; the reference's einsum sums its 2S rows in
// another order, so the kernel and the twin agree to f32 rounding, not bits.
//
// What bounds it on the H100: f32 arithmetic, ~800 S + 7,000 FLOP a
// hypothesis (S = 6: ~12k; 16k hypotheses at the smoke's shape are ~0.2
// GFLOP, ~3 us at the f32 peak); inputs are 28 bytes a correspondence and 4 a
// sample index, outputs 48 bytes a hypothesis. The 12 x 12 factor's 78
// floats and its loops spill to local memory (L1-resident per thread): a
// simple kernel first.
#include "sfm_geom.cuh"

namespace {

constexpr int NT = 128;
constexpr float kEps = 1e-12f;

// The polar decomposition of [M | p4] (pnp.py::pnp_dlt's decompose) with
// sign sg = +-1 applied to P; returns the mean depth of the sample under
// (R, t): rows `row` of the candidate's world points P3. v: the smallest
// eigenvector of M^T M (the same for both signs).
__device__ float decompose(const float* P, float sg, const float* v, const float* P3,
                           const int* row, int S, float* R, float* t) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = sg * P[4 * i + j];
  float n2 = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) n2 += M[k] * M[k];
  const float nrm = fmaxf(sqrtf(n2), kEps);
  float X[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) X[k] = M[k] / nrm;
  for (int it = 0; it < 12; ++it) {
    float G[9], Y[9];  // G = X X^T, Y = G X
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        G[i * 3 + j] =
            X[i * 3] * X[j * 3] + X[i * 3 + 1] * X[j * 3 + 1] + X[i * 3 + 2] * X[j * 3 + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Y[i * 3 + j] = G[i * 3] * X[j] + G[i * 3 + 1] * X[3 + j] + G[i * 3 + 2] * X[6 + j];
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = 1.5f * X[k] - 0.5f * Y[k];
  }
  float nuclear = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) nuclear += X[k] * M[k];
  const float det = X[0] * (X[4] * X[8] - X[5] * X[7]) - X[1] * (X[3] * X[8] - X[5] * X[6]) +
                    X[2] * (X[3] * X[7] - X[4] * X[6]);
  if (det < 0.f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float pv = X[i * 3] * v[0] + X[i * 3 + 1] * v[1] + X[i * 3 + 2] * v[2];
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i * 3 + j] = X[i * 3 + j] - 2.f * pv * v[j];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = X[k];
  }
  const float scale = 3.f / fmaxf(nuclear, kEps);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sg * P[4 * i + 3] * scale;
  float zs = 0.f;
  for (int n = 0; n < S; ++n) {
    const float* X3 = P3 + 3 * row[n];
    zs += R[6] * X3[0] + R[7] * X3[1] + R[8] * X3[2] + t[2];
  }
  return zs / fmaxf((float)S, kEps);
}

__global__ void __launch_bounds__(NT) pnp_dlt_kernel(
    const float* __restrict__ pts3d, const float* __restrict__ pn,
    const float* __restrict__ pts2d, const int* __restrict__ idx,
    const float* __restrict__ intr, int B, int H, int S, int N, float* __restrict__ Rs,
    float* __restrict__ ts) {
  const long long g = (long long)blockIdx.x * NT + threadIdx.x;
  if (g >= (long long)B * H) return;
  const int b = (int)(g / H);
  const int* row = idx + g * S;
  const float* P3 = pts3d + (size_t)b * N * 3;
  const float* PN = pn + (size_t)b * N * 2;
  const float* P2 = pts2d + (size_t)b * N * 2;

  // 1. The normal matrix of the row-normalized DLT system.
  float A[78];
#pragma unroll
  for (int e = 0; e < 78; ++e) A[e] = 0.f;
  for (int n = 0; n < S; ++n) {
    const int r = row[n];
    const float* X = P3 + 3 * r;
    const float X1[4] = {X[0], X[1], X[2], 1.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float u = PN[2 * r + half];
      float a[12];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = half == 0 ? X1[k] : 0.f;
        a[4 + k] = half == 0 ? 0.f : X1[k];
        a[8 + k] = -u * X1[k];
      }
      float n2 = 0.f;
#pragma unroll
      for (int k = 0; k < 12; ++k) n2 += a[k] * a[k];
      const float nrm = fmaxf(sqrtf(n2), kEps);
#pragma unroll
      for (int k = 0; k < 12; ++k) a[k] /= nrm;
#pragma unroll
      for (int i = 0; i < 12; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) A[sfm_pk(i, j)] += a[i] * a[j];
    }
  }

  // 2. Its null vector (smallest_eigvec, fallback=False).
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) tr += A[sfm_pk(i, i)];
  sfm_cholesky_clamped<12>(A, 1e-6f * (tr / 12.f) + 1e-20f, A);
  float p[12];
  sfm_inverse_iterate<12>(A, 8, p);

  // 3. P and -P onto SO(3) x R^3; the sign with the points in front.
  float MtM[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      MtM[i][j] = p[i] * p[j] + p[4 + i] * p[4 + j] + p[8 + i] * p[8 + j];
  float v[3];
  sfm_smallest_eigvec3(MtM, v);
  float R[9], t[3], Rn[9], tn[3];
  const float zp = decompose(p, 1.f, v, P3, row, S, R, t);
  const float zn = decompose(p, -1.f, v, P3, row, S, Rn, tn);
  if (!(zp >= zn)) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = tn[k];
  }

  // 4. Two Gauss-Newton steps on the sample.
  const float k4[4] = {intr[0], intr[1], intr[2], intr[3]};
  float params[6];
  sfm_rotation_to_rvec(R, params);
#pragma unroll
  for (int k = 0; k < 3; ++k) params[3 + k] = t[k];
  for (int it = 0; it < 2; ++it) {
    float Rg[9], dR[3][9];
    sfm_rodrigues_d(params, Rg, dR);
    float acc[27];
#pragma unroll
    for (int m = 0; m < 27; ++m) acc[m] = 0.f;
    for (int n = 0; n < S; ++n) {
      const int r = row[n];
      const float* X = P3 + 3 * r;
      float xc[3], dxc[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xc[i] = Rg[i * 3] * X[0] + Rg[i * 3 + 1] * X[1] + Rg[i * 3 + 2] * X[2] + params[3 + i];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dxc[i][j] = dR[j][i * 3] * X[0] + dR[j][i * 3 + 1] * X[1] + dR[j][i * 3 + 2] * X[2];
          dxc[i][3 + j] = i == j ? 1.f : 0.f;
        }
      }
      const bool clamp = fabsf(xc[2]) < kEps;
      const float z = clamp ? kEps : xc[2];
      float res[2], J[2][6];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float f = k4[c], num = f * xc[c];
        res[c] = num / z + k4[2 + c] - P2[2 * r + c];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float dz = clamp ? 0.f : dxc[2][j];
          J[c][j] = (f * dxc[c][j]) / z - num * dz / (z * z);
        }
      }
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) acc[e++] += J[0][i] * J[0][j] + J[1][i] * J[1][j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += J[0][i] * res[0] + J[1][i] * res[1];
    }
    float delta[6];
    sfm_solve6(acc, acc + 21, delta, 1e-4f, true);  // (J^T J + 1e-4 I) delta = J^T r
#pragma unroll
    for (int k = 0; k < 6; ++k) params[k] -= delta[k];
  }

  // 5. The hypothesis.
  float Rf[9];
  sfm_rodrigues_d(params, Rf, nullptr);
#pragma unroll
  for (int k = 0; k < 9; ++k) Rs[g * 9 + k] = Rf[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) ts[g * 3 + k] = params[3 + k];
}

}  // namespace

// pts3d (B, N, 3), pn (B, N, 2) normalized, pts2d (B, N, 2) pixels, idx
// (B, H, S) int32 rows of each candidate, intr (fx, fy, cx, cy); out Rs
// (B, H, 3, 3), ts (B, H, 3).
SFM_API int sfm_pnp_dlt_solve(const void* pts3d, const void* pn, const void* pts2d,
                              const void* idx, const void* intr, int B, int H, int S, int N,
                              void* Rs, void* ts, void* stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)B * H;
  if (n > 0) {
    pnp_dlt_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts3d), static_cast<const float*>(pn),
        static_cast<const float*>(pts2d), static_cast<const int*>(idx),
        static_cast<const float*>(intr), B, H, S, N, static_cast<float*>(Rs),
        static_cast<float*>(ts));
  }
  return static_cast<int>(cudaGetLastError());
}
