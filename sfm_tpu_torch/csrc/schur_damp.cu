// Kernel K10, the per-lambda parts around the coupling: LM damping with the
// reduced right-hand side, and the point back-substitution (two entries).
//
// Replaces sfm_tpu/ba/schur.py::damp_operator (:174: the (P, 3, 3) damped point
// blocks inverted by jnp.linalg.inv, the damping diagonals and
// rhs_reduced = -g + W Vinv g_p by segment sums over the observations) and
// ::back_substitute (:459: dp = Vinv (-g_p - W^T dx)), which XLA ran as
// batched 3x3 inverses, gathers, small batched matmuls and scatter-adds.
//
// sfm_schur_damp launches two kernels:
//  1. one thread per point: Vd = V + (lambda diag V + 1e-10) I, inverted by
//     the 3x3 adjugate after a symmetric Jacobi scaling (D^-1/2 Vd D^-1/2 has a
//     unit diagonal, so the determinant stays in range whatever the point's
//     scale), zero for invalid points; the same threads write the camera and
//     intrinsics damping diagonals (with the unit pin on dead camera entries)
//     and start rhs_c = -g_c, rhs_k = -g_k.
//  2. one thread per row of the per-point grouping (schur.py::coobs_pairs,
//     the grouping K8+K9 and the coupling kernel walk): h_p = Vinv g_p, then
//     per observation y_o = Jp_o h_p, summed as Jc_o^T y_o into its camera's
//     rhs (a per-block copy in shared memory, flushed with one global atomic
//     per entry, as K8+K9 do: float atomics, another order every run) and as
//     Jk_o^T y_o into rhs_k.
// sfm_schur_back_substitute: dp = Vinv (-g_p) for every point, then one
// thread per grouping row overwrites its point's dp with
// Vinv (-g_p - sum_o Jp_o^T (Jc_o xc + Jk_o xk)); no atomics, deterministic.
//
// What bounds it on the H100: memory. At 200k observations and 20k points
// the damping reads ~100 bytes an observation and ~60 a point (~21 MB, ~6 us
// at 3.35 TB/s); ~80 FLOP an observation is nothing. Launch latency and the
// camera atomics dominate at these sizes.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr float kEps = 1e-10f;

// Inverse of a 3x3 matrix by the adjugate after Jacobi scaling.
__device__ void inv3_scaled(const float* A, float* out) {
  float s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = A[i * 4] > 0.f ? 1.f / sqrtf(A[i * 4]) : 1.f;
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = A[i * 3 + j] * s[i] * s[j];
  // adj(M): its columns are the cross products of M's rows (linalg.py::_adjugate3).
  const float c[3][3] = {
      {M[4] * M[8] - M[5] * M[7], M[5] * M[6] - M[3] * M[8], M[3] * M[7] - M[4] * M[6]},
      {M[7] * M[2] - M[8] * M[1], M[8] * M[0] - M[6] * M[2], M[6] * M[1] - M[7] * M[0]},
      {M[1] * M[5] - M[2] * M[4], M[2] * M[3] - M[0] * M[5], M[0] * M[4] - M[1] * M[3]}};
  const float det = M[0] * c[0][0] + M[1] * c[0][1] + M[2] * c[0][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 3 + j] = s[i] * (c[j][i] / det) * s[j];
}

__global__ void __launch_bounds__(NT) damp_point_kernel(
    const float* __restrict__ V, const uint8_t* __restrict__ point_valid,
    const float* __restrict__ U, const float* __restrict__ Uk, const float* __restrict__ g_c,
    const float* __restrict__ g_k, int P, int C, float lam, float* __restrict__ Vinv,
    float* __restrict__ lam_diag_c, float* __restrict__ lam_diag_k, float* __restrict__ rhs_c,
    float* __restrict__ rhs_k) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < P) {
    float out[9];
    if (point_valid[i]) {
      float Vd[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Vd[k] = V[(size_t)i * 9 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) Vd[k * 4] = Vd[k * 4] + (lam * Vd[k * 4] + kEps);
      inv3_scaled(Vd, out);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) out[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Vinv[(size_t)i * 9 + k] = out[k];
  }
  if (i < 6 * C) {
    const float d = U[(size_t)(i / 6) * 36 + (i % 6) * 7];
    lam_diag_c[i] = lam * d + (d <= kEps ? 1.f : 0.f);
    rhs_c[i] = -g_c[i];
  }
  if (i < 4) {
    lam_diag_k[i] = lam * Uk[i * 5] + kEps;
    rhs_k[i] = -g_k[i];
  }
}

__global__ void __launch_bounds__(NT) damp_rhs_kernel(
    const float* __restrict__ Jc, const float* __restrict__ Jk, const float* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs, int C,
    const float* __restrict__ Vinv, const float* __restrict__ g_p, float* __restrict__ rhs_c,
    float* __restrict__ rhs_k) {
  extern __shared__ float s_rhs[];  // C x 6 camera sums, then 4 intrinsics sums
  for (int i = threadIdx.x; i < 6 * C + 4; i += NT) s_rhs[i] = 0.f;
  __syncthreads();
  const int g = blockIdx.x * NT + threadIdx.x;
  float rk[4] = {0.f, 0.f, 0.f, 0.f};
  if (g < G && perm_valid[(size_t)g * Vs]) {
    const int p = obs_point[perm[(size_t)g * Vs]];
    const float* Vi = Vinv + (size_t)p * 9;
    const float* gp = g_p + (size_t)p * 3;
    float h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) h[i] = Vi[i * 3] * gp[0] + Vi[i * 3 + 1] * gp[1] + Vi[i * 3 + 2] * gp[2];
    for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
      const int o = perm[(size_t)g * Vs + s];
      const float* jp = Jp + (size_t)o * 6;
      const float y0 = jp[0] * h[0] + jp[1] * h[1] + jp[2] * h[2];
      const float y1 = jp[3] * h[0] + jp[4] * h[1] + jp[5] * h[2];
      const float* jc = Jc + (size_t)o * 12;
      float* rc = s_rhs + 6 * obs_cam[o];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float v = jc[k] * y0 + jc[6 + k] * y1;
        if (v != 0.f) atomicAdd(&rc[k], v);
      }
      const float* jk = Jk + (size_t)o * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k) rk[k] += jk[k] * y0 + jk[4 + k] * y1;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = rk[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (threadIdx.x % 32 == 0 && v != 0.f) atomicAdd(&s_rhs[6 * C + k], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * C; i += NT)
    if (s_rhs[i] != 0.f) atomicAdd(&rhs_c[i], s_rhs[i]);
  if (threadIdx.x < 4 && s_rhs[6 * C + threadIdx.x] != 0.f)
    atomicAdd(&rhs_k[threadIdx.x], s_rhs[6 * C + threadIdx.x]);
}

__device__ __forceinline__ void point_step(const float* Vi, const float* gp, const float* u,
                                           float* dp) {
  const float r[3] = {-gp[0] - u[0], -gp[1] - u[1], -gp[2] - u[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) dp[i] = Vi[i * 3] * r[0] + Vi[i * 3 + 1] * r[1] + Vi[i * 3 + 2] * r[2];
}

__global__ void __launch_bounds__(NT) back_point_kernel(const float* __restrict__ Vinv,
                                                        const float* __restrict__ g_p, int P,
                                                        float* __restrict__ dp) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= P) return;
  const float u[3] = {0.f, 0.f, 0.f};
  point_step(Vinv + (size_t)p * 9, g_p + (size_t)p * 3, u, dp + (size_t)p * 3);
}

__global__ void __launch_bounds__(NT) back_row_kernel(
    const float* __restrict__ Jc, const float* __restrict__ Jk, const float* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs,
    const float* __restrict__ Vinv, const float* __restrict__ g_p, const float* __restrict__ xc,
    const float* __restrict__ xk, float* __restrict__ dp) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= G || !perm_valid[(size_t)g * Vs]) return;
  float k4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) k4[k] = xk[k];
  float u[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
    const int o = perm[(size_t)g * Vs + s];
    const float* x = xc + (size_t)obs_cam[o] * 6;
    const float* jc = Jc + (size_t)o * 12;
    const float* jk = Jk + (size_t)o * 8;
    const float* jp = Jp + (size_t)o * 6;
    float a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float ac = 0.f, ak = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) ac += jc[r * 6 + k] * x[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) ak += jk[r * 4 + k] * k4[k];
      a[r] = ac + ak;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] += jp[i] * a[0] + jp[3 + i] * a[1];
  }
  const int p = obs_point[perm[(size_t)g * Vs]];
  point_step(Vinv + (size_t)p * 9, g_p + (size_t)p * 3, u, dp + (size_t)p * 3);
}

}  // namespace

SFM_API int sfm_schur_damp(const void* V, const void* point_valid, const void* U, const void* Uk,
                           const void* g_c, const void* g_k, const void* g_p, const void* Jc,
                           const void* Jk, const void* Jp, const void* obs_cam,
                           const void* obs_point, const void* perm, const void* perm_valid,
                           int P, int C, int G, int Vs, float lam, void* Vinv, void* lam_diag_c,
                           void* lam_diag_k, void* rhs_c, void* rhs_k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n1 = max(max(P, 6 * C), 4);
  damp_point_kernel<<<(n1 + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(V), static_cast<const uint8_t*>(point_valid),
      static_cast<const float*>(U), static_cast<const float*>(Uk),
      static_cast<const float*>(g_c), static_cast<const float*>(g_k), P, C, lam,
      static_cast<float*>(Vinv), static_cast<float*>(lam_diag_c),
      static_cast<float*>(lam_diag_k), static_cast<float*>(rhs_c), static_cast<float*>(rhs_k));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || G == 0) return static_cast<int>(e);
  const size_t smem = (size_t)(6 * C + 4) * sizeof(float);
  e = cudaFuncSetAttribute(damp_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  damp_rhs_kernel<<<(G + NT - 1) / NT, NT, smem, st>>>(
      static_cast<const float*>(Jc), static_cast<const float*>(Jk),
      static_cast<const float*>(Jp), static_cast<const int*>(obs_cam),
      static_cast<const int*>(obs_point), static_cast<const int*>(perm),
      static_cast<const uint8_t*>(perm_valid), G, Vs, C, static_cast<const float*>(Vinv),
      static_cast<const float*>(g_p), static_cast<float*>(rhs_c), static_cast<float*>(rhs_k));
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_schur_back_substitute(const void* Jc, const void* Jk, const void* Jp,
                                      const void* obs_cam, const void* obs_point,
                                      const void* perm, const void* perm_valid, const void* Vinv,
                                      const void* g_p, const void* xc, const void* xk, int P,
                                      int G, int Vs, void* dp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0) {
    back_point_kernel<<<(P + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const float*>(Vinv), static_cast<const float*>(g_p), P,
        static_cast<float*>(dp));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (G > 0) {
    back_row_kernel<<<(G + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const float*>(Jc), static_cast<const float*>(Jk),
        static_cast<const float*>(Jp), static_cast<const int*>(obs_cam),
        static_cast<const int*>(obs_point), static_cast<const int*>(perm),
        static_cast<const uint8_t*>(perm_valid), G, Vs, static_cast<const float*>(Vinv),
        static_cast<const float*>(g_p), static_cast<const float*>(xc),
        static_cast<const float*>(xk), static_cast<float*>(dp));
  }
  return static_cast<int>(cudaGetLastError());
}
