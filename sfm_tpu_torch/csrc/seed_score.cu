// Kernel K14: seed-pair scoring, pose recovery plus parallax and two-view
// consistency, over a batch of candidate pairs.
//
// Replaces sfm_tpu/reconstruction/seed.py::_score_pairs (:51), the vmapped
// program of E = K^T F K, Horn's decomposition, the four-way cheirality test,
// the two-view DLT, reprojection, parallax and two bisection medians, whose
// (P, 4, N) intermediates go through device memory. The plain twin
// (sfm_tpu_torch/reconstruction/seed.py::_score_pairs_plain) issues some
// hundreds of small launches.
//
// What bounds it on the H100: nothing much; it runs once per reconstruction on
// P <= 256 pairs of N <= 256 matches (three 4x4 DLT solves per match). It is
// latency-bound: one launch instead of the twin's hundreds.
//
// Design: one block per pair, one thread per match. Every thread computes the
// pair's 3x3 algebra redundantly in registers (E, En En^T's smallest
// eigenvector by the adjugate path of utils/linalg.py::smallest_eigvec, three
// Newton orthonormalization steps: no SVD), then triangulates its match under
// both rotations. The four cheirality counts are __syncthreads_count
// reductions and the first maximum wins, as torch.argmax. Each masked median
// is 24 bisection rounds of one block count each; an empty mask gives +inf.
#include "sfm_geom.cuh"

namespace {

constexpr int MAX_N = 1024;

// Pixel and depth of X under (R, t, K), as geometry/projection.py::project.
__device__ float project(const float K[3][3], const float R[3][3], const float t[3],
                         const float X[3], float px[2]) {
  float xc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) xc[i] = R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2] + t[i];
  const float z = fabsf(xc[2]) < 1e-12f ? 1e-12f : xc[2];
  px[0] = K[0][0] * xc[0] / z + K[0][2];
  px[1] = K[1][1] * xc[1] / z + K[1][2];
  return xc[2];
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// seed.py::_masked_median: the median of x over the block's `use` threads by
// 24 rounds of bisection on [0, max]; +inf when no thread is in.
__device__ float masked_median(float x, bool use, float* red) {
  const int n = __syncthreads_count(use);
  const int target = (n + 1) / 2;
  float lo = 0.f;
  float hi = block_max(use ? x : 0.f, red);
  for (int it = 0; it < 24; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool hit = __syncthreads_count(use && x <= mid) >= target;
    lo = hit ? lo : mid;
    hi = hit ? mid : hi;
  }
  return n > 0 ? hi : INFINITY;
}

__global__ void seed_score_kernel(const float* __restrict__ Fs, const float* __restrict__ xy1,
                                  const float* __restrict__ xy2,
                                  const uint8_t* __restrict__ valid,
                                  const float* __restrict__ Kmat, int N,
                                  float* __restrict__ score, float* __restrict__ R_out,
                                  float* __restrict__ t_out, float* __restrict__ par_out,
                                  float* __restrict__ err_out) {
  __shared__ float red[32];
  const int p = blockIdx.x;
  const int m = threadIdx.x;
  const bool in = m < N;
  const size_t row = (size_t)p * N + (in ? m : 0);
  const bool w = in && valid[row] != 0;
  const float p1[2] = {in ? xy1[2 * row] : 0.f, in ? xy1[2 * row + 1] : 0.f};
  const float p2[2] = {in ? xy2[2 * row] : 0.f, in ? xy2[2 * row + 1] : 0.f};

  float K[3][3], F[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    K[i / 3][i % 3] = Kmat[i];
    F[i / 3][i % 3] = Fs[(size_t)p * 9 + i];
  }
  // E = K^T F K.
  float KtF[3][3], E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KtF[i][j] = K[0][i] * F[0][j] + K[1][i] * F[1][j] + K[2][i] * F[2][j];
  sfm_matmul3(KtF, K, E);
  // Horn's decomposition and the four-way cheirality vote (recover_pose).
  float R[3][3], tb[3];
  bool mask;
  int count;
  sfm_recover_pose(E, K, p1, p2, w, R, tb, &mask, &count);
  const float I3[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  const float zero3[3] = {0.f, 0.f, 0.f};
  float P1[12], P2[12];
  sfm_camera(K, I3, zero3, P1);

  // Two-view consistency and parallax under the chosen pose.
  sfm_camera(K, R, tb, P2);
  float X[3], pr1[2], pr2[2];
  sfm_triangulate2(P1, P2, p1, p2, X);
  const float z1 = project(K, I3, zero3, X, pr1);
  const float z2 = project(K, R, tb, X, pr2);
  const float e1 = sqrtf((pr1[0] - p1[0]) * (pr1[0] - p1[0]) + (pr1[1] - p1[1]) * (pr1[1] - p1[1]));
  const float e2 = sqrtf((pr2[0] - p2[0]) * (pr2[0] - p2[0]) + (pr2[1] - p2[1]) * (pr2[1] - p2[1]));
  const bool use = mask && z1 > 0.f && z2 > 0.f;
  const float med_err = masked_median(fmaxf(e1, e2), use, red);

  float c2[3], r2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) c2[i] = -(R[0][i] * tb[0] + R[1][i] * tb[1] + R[2][i] * tb[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) r2[i] = X[i] - c2[i];
  const float nx = sqrtf(X[0] * X[0] + X[1] * X[1] + X[2] * X[2]);
  const float nr = sqrtf(r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2]);
  const float cosang = (X[0] * r2[0] + X[1] * r2[1] + X[2] * r2[2]) / fmaxf(nx * nr, 1e-12f);
  const float ang = acosf(fminf(fmaxf(cosang, -1.f), 1.f)) * (180.f / 3.14159265358979f);
  const float med_par = masked_median(ang, use, red);

  if (threadIdx.x == 0) {
    const float consistent = med_err < 3.f ? 1.f : 0.f;
    score[p] = (float)count * fminf(fmaxf(med_par, 0.f), 10.f) * consistent;
#pragma unroll
    for (int i = 0; i < 9; ++i) R_out[(size_t)p * 9 + i] = R[i / 3][i % 3];
#pragma unroll
    for (int i = 0; i < 3; ++i) t_out[(size_t)p * 3 + i] = tb[i];
    par_out[p] = med_par;
    err_out[p] = med_err;
  }
}

}  // namespace

SFM_API int sfm_seed_score(const void* Fs, const void* xy1, const void* xy2, const void* valid,
                           const void* K, int P, int N, void* score, void* R, void* t,
                           void* med_par, void* med_err, void* stream) {
  if (N < 1 || N > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    const int threads = (N + 31) / 32 * 32;
    seed_score_kernel<<<P, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Fs), static_cast<const float*>(xy1),
        static_cast<const float*>(xy2), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(K), N, static_cast<float*>(score), static_cast<float*>(R),
        static_cast<float*>(t), static_cast<float*>(med_par), static_cast<float*>(med_err));
  }
  return static_cast<int>(cudaGetLastError());
}
