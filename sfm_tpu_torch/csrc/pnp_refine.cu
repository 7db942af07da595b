// Kernel K6, second half: the two Gauss-Newton refits of the RANSAC winner.
//
// Replaces sfm_tpu/estimators/pnp.py::pnp_ransac_batch from the winning
// hypothesis onward (:329-361): refine_pose_gn (:201, a fori_loop of _gn_step,
// jax.jacfwd of the weighted reprojection residual and a 6x6 solve) on the
// winner's consensus set, re-derived weights, a second refit, then the final
// errors, inliers, count, min_inliers gate and finite guard. There every step
// is a (2N, 6) Jacobian in device memory and a batched solve; here one launch
// does all 20 steps.
//
// Design: one block per candidate (B <= 8 on registration, 1 on the guided
// rescue; N <= 8192). Per step, every thread forms the residual and its
// Jacobian for its rows and sums J^T J (21 entries) and J^T r (6); the block
// reduces them (warp shuffles, then shared memory), thread 0 solves
// (J^T J + 1e-6 I) delta = J^T r by a 6x6 Cholesky in registers and updates
// params -= delta, the additive step in (rvec, t) of the reference.
//
// The Jacobian is the exact derivative of the twin's function, as jacfwd
// computes it: the parameters are (rvec, t), so d/d rvec goes through
// rodrigues (with its theta^2 < 1e-8 Taylor branch) -- not the
// left-perturbation -[R X]x, which is right only at rvec = 0. Rodrigues and
// its three derivative matrices are formed once per step (forward mode with 3
// tangents); per row, x_cam's 6 tangents go through the same projection
// (a clamped depth has no derivative). rotation_to_rvec runs here too, with
// the reference's three regimes. The weights multiply the residual, so a
// zero-weight row adds nothing and all-zero weights give a zero step.
//
// What bounds it on the H100: nothing of the card's rates -- 20 steps x N rows
// x ~150 FLOP is 25 MFLOP for B = 8 x 2048 (< 1 us at the f32 peak), and the
// inputs are 20 bytes a row. The block-wide reduction and thread 0's solve
// between steps (a serial chain of 20 barriers) set its time.
#include "sfm_geom.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXN = 8192;

struct Rows {
  const float* p3;
  const float* p2;
  const uint8_t* valid;
  int N;
};

// Reprojection error and depth of row n under (R, t).
__device__ __forceinline__ float row_error(const Rows& rows, int n, const float* R,
                                           const float* t, const float* k4, float* depth) {
  float u, v;
  const float* X = rows.p3 + 3 * n;
  *depth = sfm_project(R, t, k4, X[0], X[1], X[2], &u, &v);
  const float du = u - rows.p2[2 * n], dv = v - rows.p2[2 * n + 1];
  return sqrtf(du * du + dv * dv);
}

// Weights of the next refit: err < thr, depth > 0, valid (and gate).
__device__ void set_weights(const Rows& rows, const float* R, const float* t,
                            const float* k4, float thr, bool gate, uint8_t* w) {
  for (int n = threadIdx.x; n < rows.N; n += NT) {
    float depth;
    const float err = row_error(rows, n, R, t, k4, &depth);
    w[n] = err < thr && depth > 0.f && rows.valid[n] && gate;
  }
  __syncthreads();
}

// refine_pose_gn: iters steps from params (rvec, t), in shared memory.
__device__ void refine(const Rows& rows, const uint8_t* w, const float* k4, int iters,
                       float* params, float (*red)[27]) {
  for (int it = 0; it < iters; ++it) {
    float R[9], dR[3][9];
    sfm_rodrigues_d(params, R, dR);
    const float t[3] = {params[3], params[4], params[5]};
    float acc[27];
#pragma unroll
    for (int m = 0; m < 27; ++m) acc[m] = 0.f;
    for (int n = threadIdx.x; n < rows.N; n += NT) {
      if (!w[n]) continue;
      const float* X = rows.p3 + 3 * n;
      float xc[3], dxc[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xc[i] = R[i * 3] * X[0] + R[i * 3 + 1] * X[1] + R[i * 3 + 2] * X[2] + t[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          dxc[i][j] = dR[j][i * 3] * X[0] + dR[j][i * 3 + 1] * X[1] + dR[j][i * 3 + 2] * X[2];
          dxc[i][3 + j] = i == j ? 1.f : 0.f;
        }
      }
      const bool clamp = fabsf(xc[2]) < 1e-12f;
      const float z = clamp ? 1e-12f : xc[2];
      float r[2], J[2][6];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float f = k4[c], num = f * xc[c];
        r[c] = num / z + k4[2 + c] - rows.p2[2 * n + c];
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
      for (int i = 0; i < 6; ++i) acc[21 + i] += J[0][i] * r[0] + J[1][i] * r[1];
    }
    sfm_block_sum<NT, 27>(acc, red);
    if (threadIdx.x == 0) {
      float delta[6];
      sfm_solve6(acc, acc + 21, delta, 1e-6f, false);  // (J^T J + 1e-6 I) delta = J^T r
      for (int k = 0; k < 6; ++k) params[k] -= delta[k];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) pnp_refine_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0, const uint8_t* __restrict__ ok0,
    const float* __restrict__ pts3d, const float* __restrict__ pts2d,
    const uint8_t* __restrict__ valid, const float* __restrict__ intr, int N, float thr,
    const int* __restrict__ min_inliers, int iters, float* __restrict__ R_out,
    float* __restrict__ rvec_out, float* __restrict__ t_out, uint8_t* __restrict__ inl_out,
    int* __restrict__ num_out, float* __restrict__ err_out, uint8_t* __restrict__ ok_out) {
  __shared__ uint8_t w[MAXN];
  __shared__ float red[NT / 32][27];
  __shared__ float params[6];
  __shared__ int s_count;
  const int b = blockIdx.x;
  const Rows rows{pts3d + (size_t)b * N * 3, pts2d + (size_t)b * N * 2, valid + (size_t)b * N, N};
  float k4[4];
  for (int k = 0; k < 4; ++k) k4[k] = intr[k];

  float R[9], t[3];
  for (int k = 0; k < 9; ++k) R[k] = R0[b * 9 + k];
  for (int k = 0; k < 3; ++k) t[k] = t0[b * 3 + k];
  if (threadIdx.x == 0) {
    sfm_rotation_to_rvec(R, params);
    for (int k = 0; k < 3; ++k) params[3 + k] = t[k];
    s_count = 0;
  }
  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier
  refine(rows, w, k4, iters, params, red);

  // Re-derive the weights at the refined pose; the second refit starts from
  // rotation_to_rvec(rodrigues(params)), as refine_pose_gn does.
  sfm_rodrigues_d(params, R, nullptr);
  for (int k = 0; k < 3; ++k) t[k] = params[3 + k];
  __syncthreads();
  if (threadIdx.x == 0) sfm_rotation_to_rvec(R, params);
  set_weights(rows, R, t, k4, thr, true, w);
  refine(rows, w, k4, iters, params, red);

  sfm_rodrigues_d(params, R, nullptr);
  for (int k = 0; k < 3; ++k) t[k] = params[3 + k];
  bool finite = true;
  for (int k = 0; k < 9; ++k) finite = finite && isfinite(R[k]);
  for (int k = 0; k < 3; ++k) finite = finite && isfinite(t[k]);
  int count = 0;
  for (int n = threadIdx.x; n < N; n += NT) {
    float depth;
    const float err = row_error(rows, n, R, t, k4, &depth);
    const bool inl = err < thr && depth > 0.f && rows.valid[n];
    count += inl;
    inl_out[(size_t)b * N + n] = inl && finite;
    err_out[(size_t)b * N + n] = isfinite(err) ? err : INFINITY;
  }
  atomicAdd(&s_count, count);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!finite) {
      for (int k = 0; k < 9; ++k) R[k] = k % 4 == 0 ? 1.f : 0.f;
      for (int k = 0; k < 3; ++k) t[k] = 0.f;
    }
    for (int k = 0; k < 9; ++k) R_out[b * 9 + k] = R[k];
    for (int k = 0; k < 3; ++k) t_out[b * 3 + k] = t[k];
    sfm_rotation_to_rvec(R, rvec_out + b * 3);
    num_out[b] = finite ? s_count : 0;
    ok_out[b] = s_count >= min_inliers[b] && finite;
  }
}

}  // namespace

SFM_API int sfm_pnp_refine(const void* R0, const void* t0, const void* ok0, const void* pts3d,
                           const void* pts2d, const void* valid, const void* intr, int B, int N,
                           float thr, const void* min_inliers, int iters, void* R, void* rvec,
                           void* t, void* inliers, void* num, void* errors, void* ok,
                           void* stream) {
  if (N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    pnp_refine_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(R0), static_cast<const float*>(t0),
        static_cast<const uint8_t*>(ok0), static_cast<const float*>(pts3d),
        static_cast<const float*>(pts2d), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(intr), N, thr, static_cast<const int*>(min_inliers), iters,
        static_cast<float*>(R), static_cast<float*>(rvec), static_cast<float*>(t),
        static_cast<uint8_t*>(inliers), static_cast<int*>(num), static_cast<float*>(errors),
        static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
