// Kernel K13-a: relative poses of every averaging pair.
//
// Replaces the vmapped device program of
// sfm_tpu/reconstruction/global_init.py::pairwise_relative_poses (:147-183):
// per pair, the weighted normalized eight-point E on the pair's inlier rows
// in normalized camera coordinates, recover_pose with K = I, then 10
// Gauss-Newton steps on the weighted Sampson residual of E = [t]x R(rvec)
// (jax.jacfwd's Jacobian, the gauge term t t^T, a ridge of 1e-4 tr(H) / 6 +
// 1e-12, the unrolled-Cholesky 6x6 solve, the 0.5 step clip, |t| = 1), and a
// second recover_pose on the refined E. XLA runs the (S, 6) Jacobians and the
// four cheirality triangulations of every pair through device memory.
//
// Design: one block per pair, one thread per row (S <= 256 rows: the
// global_init.pair_matches subsample). The eight-point sums and the Gauss-
// Newton normal equations (21 + 6 entries) are deterministic block
// reductions; thread 0 solves; the cheirality counts are __syncthreads_count.
// The rank-2 projection of E is F (I - v v^T) (sfm_geom.cuh), not the
// reference's SVD: the same truncation, and the Gauss-Newton steps refine
// whatever E it gives. The Jacobian differentiates rodrigues forward with its
// Taylor branch, as jacfwd does, and a clamped Sampson denominator
// (max(den, 1e-12)) has no derivative.
//
// What bounds it on the H100: neither rate. Per pair ~12 block reductions
// and ~25 serial thread-0 steps; 10 steps x S rows x ~400 FLOP is ~1 MFLOP a
// pair, and the inputs are 20 bytes a row. Latency of the reduction chain
// sets its time; the pairs run in parallel on the SMs.
#include "sfm_geom.cuh"

namespace {

constexpr int NT = 256;  // threads a block = the most rows a pair takes

// Sampson residual of one row under E = [t]x R and its derivatives along the
// six parameters (dE[k] = dE / d param_k). Returns r; J[k] = dr / d param_k.
__device__ __forceinline__ float sampson_row(const float* E, const float (*dE)[9], float x1,
                                             float y1, float x2, float y2, float w, float J[6]) {
  const float a[3] = {x1, y1, 1.f}, b[3] = {x2, y2, 1.f};
  float Ex1[3], Etx2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Ex1[i] = E[i * 3] * a[0] + E[i * 3 + 1] * a[1] + E[i * 3 + 2] * a[2];
    Etx2[i] = E[i] * b[0] + E[3 + i] * b[1] + E[6 + i] * b[2];
  }
  const float num = b[0] * Ex1[0] + b[1] * Ex1[1] + b[2] * Ex1[2];
  const float den = Ex1[0] * Ex1[0] + Ex1[1] * Ex1[1] + Etx2[0] * Etx2[0] + Etx2[1] * Etx2[1];
  const bool live = den > 1e-12f;
  const float s = sqrtf(live ? den : 1e-12f);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float* d = dE[k];
    float dEx1[3], dEtx2[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dEx1[i] = d[i * 3] * a[0] + d[i * 3 + 1] * a[1] + d[i * 3 + 2] * a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) dEtx2[i] = d[i] * b[0] + d[3 + i] * b[1] + d[6 + i] * b[2];
    const float dnum = b[0] * dEx1[0] + b[1] * dEx1[1] + b[2] * dEx1[2];
    const float dden = 2.f * (Ex1[0] * dEx1[0] + Ex1[1] * dEx1[1] + Etx2[0] * dEtx2[0] +
                              Etx2[1] * dEtx2[1]);
    const float ds = live ? dden / (2.f * s) : 0.f;
    J[k] = w * (dnum / s - num * ds / (s * s));
  }
  return w * num / s;
}

// E = [t]x R(rvec) and, when dE != nullptr, its six parameter derivatives.
__device__ __forceinline__ void essential(const float* params, float* E, float (*dE)[9]) {
  float R[9], dR[3][9];
  sfm_rodrigues_d(params, R, dE == nullptr ? nullptr : dR);
  const float* t = params + 3;
  const float T[9] = {0.f, -t[2], t[1], t[2], 0.f, -t[0], -t[1], t[0], 0.f};
  auto mul = [](const float* A, const float* B, float* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        C[i * 3 + j] = A[i * 3] * B[j] + A[i * 3 + 1] * B[3 + j] + A[i * 3 + 2] * B[6 + j];
  };
  mul(T, R, E);
  if (dE == nullptr) return;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    mul(T, dR[j], dE[j]);
    float Tj[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // skew(e_j)
    if (j == 0) { Tj[5] = -1.f; Tj[7] = 1.f; }
    if (j == 1) { Tj[2] = 1.f; Tj[6] = -1.f; }
    if (j == 2) { Tj[1] = -1.f; Tj[3] = 1.f; }
    mul(Tj, R, dE[3 + j]);
  }
}

__global__ void __launch_bounds__(NT) relpose_kernel(
    const float* __restrict__ xn1, const float* __restrict__ xn2, const float* __restrict__ wts,
    int S, int iters, float* __restrict__ R_out, float* __restrict__ t_out,
    float* __restrict__ good_out) {
  __shared__ float sx[4][NT];  // x1, y1, x2, y2
  __shared__ float sw[NT];
  __shared__ float red[NT / 32][45];
  __shared__ float sE[9];
  __shared__ float params[6];
  const int p = blockIdx.x, n = threadIdx.x;
  const bool in = n < S;
  const size_t row = (size_t)p * S + (in ? n : 0);
  const float x1 = in ? xn1[2 * row] : 0.f, y1 = in ? xn1[2 * row + 1] : 0.f;
  const float x2 = in ? xn2[2 * row] : 0.f, y2 = in ? xn2[2 * row + 1] : 0.f;
  const float w = in ? wts[row] : 0.f;
  sx[0][n] = x1;
  sx[1][n] = y1;
  sx[2][n] = x2;
  sx[3][n] = y2;
  sw[n] = w;
  __syncthreads();

  // 1. eight_point(x1, x2, weights=w) and the first recover_pose (K = I).
  sfm_eight_point_block<NT>(sx[0], sx[1], sx[2], sx[3], sw, S, red, sE);
  const float I3[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  const float p1[2] = {x1, y1}, p2[2] = {x2, y2};
  float E33[3][3], R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) E33[i / 3][i % 3] = sE[i];
  bool mask;
  int count;
  sfm_recover_pose(E33, I3, p1, p2, w > 0.f, R, t, &mask, &count);
  const float wr = mask ? w : 0.f;  // w * mask
  if (n == 0) {
    sfm_rotation_to_rvec(&R[0][0], params);
#pragma unroll
    for (int k = 0; k < 3; ++k) params[3 + k] = t[k];
  }
  __syncthreads();

  // 2. Gauss-Newton on the weighted Sampson residual.
  for (int it = 0; it < iters; ++it) {
    float E[9], dE[6][9], acc[27];
    essential(params, E, dE);
    float J[6];
    const float r = sampson_row(E, dE, x1, y1, x2, y2, wr, J);
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j) acc[e++] = J[i] * J[j];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] = J[i] * r;
    sfm_block_sum<NT, 27>(acc, reinterpret_cast<float(*)[27]>(&red[0][0]));
    if (n == 0) {
      // H = J^T J + t t^T (the |t| gauge) + (1e-4 tr(J^T J) / 6 + 1e-12) I.
      float H[21];
      float tr = 0.f;
      e = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j, ++e) {
          H[e] = acc[e];
          if (i == j) tr += acc[e];
        }
      e = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j, ++e)
          if (i >= 3) H[e] += params[i] * params[j];
      float step[6];
      sfm_solve6(H, acc + 21, step, 1e-4f * tr / 6.f + 1e-12f, true);
      float n2 = 0.f;
      for (int k = 0; k < 6; ++k) n2 += step[k] * step[k];
      const float clip = fminf(1.f, 0.5f / fmaxf(sqrtf(n2), 1e-12f));
      for (int k = 0; k < 6; ++k) params[k] -= step[k] * clip;
      const float tn = fmaxf(sqrtf(params[3] * params[3] + params[4] * params[4] +
                                   params[5] * params[5]), 1e-9f);
      for (int k = 3; k < 6; ++k) params[k] /= tn;
    }
    __syncthreads();
  }

  // 3. The refined E's (R, t) sign by cheirality, with the input weights.
  float E[9];
  essential(params, E, nullptr);
#pragma unroll
  for (int i = 0; i < 9; ++i) E33[i / 3][i % 3] = E[i];
  sfm_recover_pose(E33, I3, p1, p2, w > 0.f, R, t, &mask, &count);
  if (n == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R_out[(size_t)p * 9 + i] = R[i / 3][i % 3];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[(size_t)p * 3 + i] = t[i];
    good_out[p] = (float)count;
  }
}

}  // namespace

SFM_API int sfm_relpose(const void* xn1, const void* xn2, const void* w, int P, int S, int iters,
                        void* R, void* t, void* good, void* stream) {
  if (S < 1 || S > NT) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    relpose_kernel<<<P, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xn1), static_cast<const float*>(xn2),
        static_cast<const float*>(w), S, iters, static_cast<float*>(R), static_cast<float*>(t),
        static_cast<float*>(good));
  }
  return static_cast<int>(cudaGetLastError());
}
