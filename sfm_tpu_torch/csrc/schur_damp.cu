// Kernel K10, the per-lambda parts around the coupling: LM damping with the
// reduced right-hand side, the point back-substitution, and K11's
// block-Jacobi preconditioner (three entries).
//
// Replaces sfm_tpu/ba/schur.py::damp_operator (:174: the (P, 3, 3) damped point
// blocks inverted by jnp.linalg.inv, the damping diagonals and
// rhs_reduced = -g + W Vinv g_p by segment sums over the observations) and
// ::back_substitute (:459: dp = Vinv (-g_p - W^T dx)), which XLA ran as
// batched 3x3 inverses, gathers, small batched matmuls and scatter-adds.
//
// sfm_schur_damp:
//  1. one thread per point: Vd = V + (lambda diag V + 1e-10) I, inverted by
//     the 3x3 adjugate after a symmetric Jacobi scaling (D^-1/2 Vd D^-1/2 has a
//     unit diagonal, so the determinant stays in range whatever the point's
//     scale), zero for invalid points; the same threads write the camera and
//     intrinsics damping diagonals (with the unit pin on dead camera entries);
//  2. one thread per row of the per-point grouping (schur.py::coobs_pairs,
//     the grouping K8+K9 and the coupling kernel walk): h_p = Vinv g_p, then
//     per observation y_o = Jp_o h_p, summed as Jc_o^T y_o into its camera's
//     rhs and as Jk_o^T y_o into rhs_k. These are order-free fixed-point
//     sums (sfm_common.cuh): a first run of the kernel takes every target's
//     largest |term|, the shifts follow, the second run adds (a per-block
//     copy in shared memory, flushed with one global atomic per entry, while
//     the WORDS x (BC + 4) words fit in 227 KB; above that -- more than
//     schur.py::max_cameras(B, T) cameras -- straight into the global words
//     with 64-bit integer atomics: the same integer sums, so the same bits);
//  3. rhs = -g + the sums, rounded once: the same bits every run.
// sfm_schur_block_jacobi (the PCG path only, more than
// use_dense_schur_below cameras): the block-Jacobi preconditioner of K11,
// schur.py:197-200, Mc = inv(U + diag(lam_diag_c) + 1e-10 I) one thread a
// camera and Mk = inv(Uk + diag(lam_diag_k) + 1e-10 I) in one more thread, by
// Gauss-Jordan elimination with partial pivoting (the reference's and the
// twin's inverse is LU with partial pivoting: the same pivots, another order
// of the updates). A pinned camera (U = 0, unit damping diagonal) gets the
// identity, as in the reference; a block that rounding leaves indefinite
// still gets its inverse, where a Cholesky would stop.
// sfm_schur_back_substitute: dp = Vinv (-g_p) for every point, then one
// thread per grouping row overwrites its point's dp with
// Vinv (-g_p - sum_o Jp_o^T (Jc_o xc + Jk_o xk)); no atomics, deterministic.
//
// All three are templated on the camera block B (6, or 10 with per-camera
// intrinsics) and on the island's scalar T (float, or double with
// BAConfig.f64_normal_equations: the right-hand side's sums take two words,
// sfm_common.cuh). The unit pin is per entry (schur.py:188-192): at B = 10
// it pins the pose rows of a camera whose intrinsics stay free.
//
// What bounds it on the H100: memory. At 200k observations and 20k points
// the damping reads ~100 bytes an observation and ~60 a point (~21 MB, ~6 us
// at 3.35 TB/s); ~80 FLOP an observation is nothing. Launch latency and the
// camera atomics dominate at these sizes.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;

template <typename T>
__device__ __forceinline__ T eps() {
  return T(1e-10);
}
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }

// Inverse of a 3x3 matrix by the adjugate after Jacobi scaling.
template <typename T>
__device__ void inv3_scaled(const T* A, T* out) {
  T s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = A[i * 4] > T(0) ? T(1) / t_sqrt(A[i * 4]) : T(1);
  T M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = A[i * 3 + j] * s[i] * s[j];
  // adj(M): its columns are the cross products of M's rows (linalg.py::_adjugate3).
  const T c[3][3] = {
      {M[4] * M[8] - M[5] * M[7], M[5] * M[6] - M[3] * M[8], M[3] * M[7] - M[4] * M[6]},
      {M[7] * M[2] - M[8] * M[1], M[8] * M[0] - M[6] * M[2], M[6] * M[1] - M[7] * M[0]},
      {M[1] * M[5] - M[2] * M[4], M[2] * M[3] - M[0] * M[5], M[0] * M[4] - M[1] * M[3]}};
  const T det = M[0] * c[0][0] + M[1] * c[0][1] + M[2] * c[0][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i * 3 + j] = s[i] * (c[j][i] / det) * s[j];
}

template <int B, typename T>
__global__ void __launch_bounds__(NT) damp_point_kernel(
    const T* __restrict__ V, const uint8_t* __restrict__ point_valid,
    const T* __restrict__ U, const T* __restrict__ Uk, int P, int C, T lam,
    T* __restrict__ Vinv, T* __restrict__ lam_diag_c, T* __restrict__ lam_diag_k) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < P) {
    T out[9];
    if (point_valid[i]) {
      T Vd[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Vd[k] = V[(size_t)i * 9 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) Vd[k * 4] = Vd[k * 4] + (lam * Vd[k * 4] + eps<T>());
      inv3_scaled<T>(Vd, out);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) out[k] = T(0);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Vinv[(size_t)i * 9 + k] = out[k];
  }
  if (i < B * C) {
    const T d = U[(size_t)(i / B) * B * B + (i % B) * (B + 1)];
    lam_diag_c[i] = lam * d + (d <= eps<T>() ? T(1) : T(0));
  }
  if (i < 4) lam_diag_k[i] = lam * Uk[i * 5] + eps<T>();
}

// SH: the block stages its sums in shared memory; otherwise they go to the
// global words directly (sfm_fx_target).
template <int B, typename T, bool ADD, bool SH>
__global__ void __launch_bounds__(NT) damp_rhs_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs, int C,
    const T* __restrict__ Vinv, const T* __restrict__ g_p, const int* __restrict__ sh,
    unsigned int* __restrict__ gmax, unsigned long long* __restrict__ gacc) {
  extern __shared__ unsigned long long s_stage[];  // C x B camera sums, then 4 intrinsics sums
  unsigned long long* s_rhs = sfm_fx_target<ADD, SH>(s_stage, gmax, gacc);
  const int n = B * C + 4;
  if (SH) sfm_fx_stage_zero<T>(s_rhs, n);
  __syncthreads();
  const int g = blockIdx.x * NT + threadIdx.x;
  SfmFxPart rk[4];
  if (g < G && perm_valid[(size_t)g * Vs]) {
    const int p = obs_point[perm[(size_t)g * Vs]];
    const T* Vi = Vinv + (size_t)p * 9;
    const T* gp = g_p + (size_t)p * 3;
    T h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) h[i] = Vi[i * 3] * gp[0] + Vi[i * 3 + 1] * gp[1] + Vi[i * 3 + 2] * gp[2];
    for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
      const int o = perm[(size_t)g * Vs + s];
      const T* jp = Jp + (size_t)o * 6;
      const T y0 = jp[0] * h[0] + jp[1] * h[1] + jp[2] * h[2];
      const T y1 = jp[3] * h[0] + jp[4] * h[1] + jp[5] * h[2];
      const T* jc = Jc + (size_t)o * 2 * B;
      const int cB = B * obs_cam[o];
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const T v = jc[k] * y0 + jc[B + k] * y1;
        if (v != T(0)) sfm_fx_put<T, ADD>(s_rhs, n, cB + k, v, sh);
      }
      const T* jk = Jk + (size_t)o * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sfm_fx_part<T, ADD>(rk[k], jk[k] * y0 + jk[4 + k] * y1, ADD ? sh[B * C + k] : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<T, ADD>(s_rhs, n, B * C + k, rk[k]);
  if (SH) {
    __syncthreads();
    sfm_fx_flush<T, ADD>(s_rhs, n, gmax, gacc);
  }
}

// rhs = -g + the sums, rounded once.
template <int B, typename T>
__global__ void __launch_bounds__(NT) damp_finish_kernel(
    const T* __restrict__ g_c, const T* __restrict__ g_k,
    const unsigned long long* __restrict__ gacc, const int* __restrict__ sh, int C,
    T* __restrict__ rhs_c, T* __restrict__ rhs_k) {
  const int i = blockIdx.x * NT + threadIdx.x;
  const int nB = B * C, n = nB + 4;
  if (i < nB) {
    rhs_c[i] = (T)(-(double)g_c[i] + sfm_fx_value_t<T>(gacc, n, i, sh[i]));
  } else if (i < n) {
    rhs_k[i - nB] = (T)(-(double)g_k[i - nB] + sfm_fx_value_t<T>(gacc, n, i, sh[i]));
  }
}

template <typename T>
__device__ __forceinline__ void point_step(const T* Vi, const T* gp, const T* u, T* dp) {
  const T r[3] = {-gp[0] - u[0], -gp[1] - u[1], -gp[2] - u[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) dp[i] = Vi[i * 3] * r[0] + Vi[i * 3 + 1] * r[1] + Vi[i * 3 + 2] * r[2];
}

template <typename T>
__global__ void __launch_bounds__(NT) back_point_kernel(const T* __restrict__ Vinv,
                                                        const T* __restrict__ g_p, int P,
                                                        T* __restrict__ dp) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= P) return;
  const T u[3] = {T(0), T(0), T(0)};
  point_step<T>(Vinv + (size_t)p * 9, g_p + (size_t)p * 3, u, dp + (size_t)p * 3);
}

template <int B, typename T>
__global__ void __launch_bounds__(NT) back_row_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs,
    const T* __restrict__ Vinv, const T* __restrict__ g_p, const T* __restrict__ xc,
    const T* __restrict__ xk, T* __restrict__ dp) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= G || !perm_valid[(size_t)g * Vs]) return;
  T k4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) k4[k] = xk[k];
  T u[3] = {T(0), T(0), T(0)};
  for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
    const int o = perm[(size_t)g * Vs + s];
    const T* x = xc + (size_t)obs_cam[o] * B;
    const T* jc = Jc + (size_t)o * 2 * B;
    const T* jk = Jk + (size_t)o * 8;
    const T* jp = Jp + (size_t)o * 6;
    T a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      T ac = T(0), ak = T(0);
#pragma unroll
      for (int k = 0; k < B; ++k) ac += jc[r * B + k] * x[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) ak += jk[r * 4 + k] * k4[k];
      a[r] = ac + ak;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] += jp[i] * a[0] + jp[3 + i] * a[1];
  }
  const int p = obs_point[perm[(size_t)g * Vs]];
  point_step<T>(Vinv + (size_t)p * 9, g_p + (size_t)p * 3, u, dp + (size_t)p * 3);
}

// inv(A) by Gauss-Jordan elimination with partial pivoting (A is overwritten).
template <int N, typename T>
__device__ void inverse_pivoted(T (&a)[N][N], T (&inv)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) inv[i][j] = i == j ? T(1) : T(0);
  for (int col = 0; col < N; ++col) {
    int piv = col;
    T best = t_abs(a[col][col]);
    for (int i = col + 1; i < N; ++i)
      if (t_abs(a[i][col]) > best) {
        best = t_abs(a[i][col]);
        piv = i;
      }
    if (piv != col)
      for (int j = 0; j < N; ++j) {
        const T t = a[col][j], u = inv[col][j];
        a[col][j] = a[piv][j];
        inv[col][j] = inv[piv][j];
        a[piv][j] = t;
        inv[piv][j] = u;
      }
    const T d = T(1) / a[col][col];
    for (int j = 0; j < N; ++j) {
      a[col][j] *= d;
      inv[col][j] *= d;
    }
    for (int i = 0; i < N; ++i) {
      if (i == col) continue;
      const T f = a[i][col];
      for (int j = 0; j < N; ++j) {
        a[i][j] -= f * a[col][j];
        inv[i][j] -= f * inv[col][j];
      }
    }
  }
}

template <int N, typename T>
__device__ __forceinline__ void damped_block_inverse(const T* Bk, const T* lam_diag, T* out) {
  T a[N][N], inv[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      a[i][j] = i == j ? (Bk[i * N + j] + lam_diag[i]) + eps<T>() : Bk[i * N + j];
  inverse_pivoted<N, T>(a, inv);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i * N + j] = inv[i][j];
}

template <int B, typename T>
__global__ void __launch_bounds__(NT) block_jacobi_kernel(
    const T* __restrict__ U, const T* __restrict__ lam_diag_c,
    const T* __restrict__ Uk, const T* __restrict__ lam_diag_k, int C,
    T* __restrict__ Mc, T* __restrict__ Mk) {
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c < C)
    damped_block_inverse<B, T>(U + (size_t)c * B * B, lam_diag_c + (size_t)c * B,
                               Mc + (size_t)c * B * B);
  else if (c == C)
    damped_block_inverse<4, T>(Uk, lam_diag_k, Mk);
}

template <int B, typename T>
int schur_block_jacobi(const void* U, const void* lam_diag_c, const void* Uk,
                       const void* lam_diag_k, int C, void* Mc, void* Mk, cudaStream_t st) {
  block_jacobi_kernel<B, T><<<C / NT + 1, NT, 0, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(lam_diag_c), static_cast<const T*>(Uk),
      static_cast<const T*>(lam_diag_k), C, static_cast<T*>(Mc), static_cast<T*>(Mk));
  return static_cast<int>(cudaGetLastError());
}

// fx_max, fx_sh: n int32 each, fx_acc: WORDS x n uint64, n = BC + 4.
template <int B, typename T>
int schur_damp(const void* V, const void* point_valid, const void* U, const void* Uk,
               const void* g_c, const void* g_k, const void* g_p, const void* Jc,
               const void* Jk, const void* Jp, const void* obs_cam, const void* obs_point,
               const void* perm, const void* perm_valid, int P, int C, int G, int Vs,
               int in_shared, T lam, void* Vinv, void* lam_diag_c, void* lam_diag_k,
               void* rhs_c, void* rhs_k, void* fx_max, void* fx_sh, void* fx_acc,
               cudaStream_t st) {
  const int n = B * C + 4;
  const int n1 = max(max(P, B * C), 4);
  unsigned int* gmax = static_cast<unsigned int*>(fx_max);
  int* sh = static_cast<int*>(fx_sh);
  unsigned long long* gacc = static_cast<unsigned long long*>(fx_acc);
  cudaError_t e = cudaMemsetAsync(gmax, 0, (size_t)n * sizeof(unsigned int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(gacc, 0, (size_t)SfmFx<T>::WORDS * n * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  damp_point_kernel<B, T><<<(n1 + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const T*>(V), static_cast<const uint8_t*>(point_valid),
      static_cast<const T*>(U), static_cast<const T*>(Uk), P, C, lam, static_cast<T*>(Vinv),
      static_cast<T*>(lam_diag_c), static_cast<T*>(lam_diag_k));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    const int blocks = (G + NT - 1) / NT;
#define DAMP_RHS_ARGS                                                                        \
  static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),           \
      static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),                  \
      static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), G, Vs, C,      \
      static_cast<const T*>(Vinv), static_cast<const T*>(g_p), sh, gmax, gacc
    if (in_shared) {
      const size_t smem = (size_t)SfmFx<T>::WORDS * n * sizeof(unsigned long long);
      e = cudaFuncSetAttribute(damp_rhs_kernel<B, T, false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(damp_rhs_kernel<B, T, true, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      damp_rhs_kernel<B, T, false, true><<<blocks, NT, smem, st>>>(DAMP_RHS_ARGS);
      sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, (double)G * Vs,
                                                               nullptr, sh);
      damp_rhs_kernel<B, T, true, true><<<blocks, NT, smem, st>>>(DAMP_RHS_ARGS);
    } else {
      damp_rhs_kernel<B, T, false, false><<<blocks, NT, 0, st>>>(DAMP_RHS_ARGS);
      sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, (double)G * Vs,
                                                               nullptr, sh);
      damp_rhs_kernel<B, T, true, false><<<blocks, NT, 0, st>>>(DAMP_RHS_ARGS);
    }
#undef DAMP_RHS_ARGS
  } else {
    sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, 1.0, nullptr, sh);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  damp_finish_kernel<B, T><<<(n + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const T*>(g_c), static_cast<const T*>(g_k), gacc, sh, C,
      static_cast<T*>(rhs_c), static_cast<T*>(rhs_k));
  return static_cast<int>(cudaGetLastError());
}

template <int B, typename T>
int schur_back_substitute(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                          const void* obs_point, const void* perm, const void* perm_valid,
                          const void* Vinv, const void* g_p, const void* xc, const void* xk,
                          int P, int G, int Vs, void* dp, cudaStream_t st) {
  if (P > 0) {
    back_point_kernel<T><<<(P + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const T*>(Vinv), static_cast<const T*>(g_p), P, static_cast<T*>(dp));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (G > 0) {
    back_row_kernel<B, T><<<(G + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), G, Vs,
        static_cast<const T*>(Vinv), static_cast<const T*>(g_p), static_cast<const T*>(xc),
        static_cast<const T*>(xk), static_cast<T*>(dp));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The default route (B = 6, float; lam a float) and the others (lam a double,
// exact for the LM loop's float32 lambda).
#define SFM_SCHUR_DAMP(NAME, B, T, LAM)                                                       \
  SFM_API int NAME(const void* V, const void* point_valid, const void* U, const void* Uk,     \
                   const void* g_c, const void* g_k, const void* g_p, const void* Jc,         \
                   const void* Jk, const void* Jp, const void* obs_cam, const void* obs_point, \
                   const void* perm, const void* perm_valid, int P, int C, int G, int Vs,     \
                   int in_shared, LAM lam, void* Vinv, void* lam_diag_c, void* lam_diag_k,    \
                   void* rhs_c, void* rhs_k, void* fx_max, void* fx_sh, void* fx_acc,         \
                   void* stream) {                                                            \
    return schur_damp<B, T>(V, point_valid, U, Uk, g_c, g_k, g_p, Jc, Jk, Jp, obs_cam,        \
                            obs_point, perm, perm_valid, P, C, G, Vs, in_shared, (T)lam,      \
                            Vinv, lam_diag_c, lam_diag_k, rhs_c, rhs_k, fx_max, fx_sh, fx_acc, \
                            static_cast<cudaStream_t>(stream));                               \
  }
SFM_SCHUR_DAMP(sfm_schur_damp, 6, float, float)
SFM_SCHUR_DAMP(sfm_schur_damp_b10, 10, float, double)
SFM_SCHUR_DAMP(sfm_schur_damp_f64, 6, double, double)
SFM_SCHUR_DAMP(sfm_schur_damp_b10_f64, 10, double, double)
#undef SFM_SCHUR_DAMP

#define SFM_SCHUR_BACK(NAME, B, T)                                                            \
  SFM_API int NAME(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,       \
                   const void* obs_point, const void* perm, const void* perm_valid,           \
                   const void* Vinv, const void* g_p, const void* xc, const void* xk, int P,  \
                   int G, int Vs, void* dp, void* stream) {                                   \
    return schur_back_substitute<B, T>(Jc, Jk, Jp, obs_cam, obs_point, perm, perm_valid,      \
                                       Vinv, g_p, xc, xk, P, G, Vs, dp,                      \
                                       static_cast<cudaStream_t>(stream));                    \
  }
SFM_SCHUR_BACK(sfm_schur_back_substitute, 6, float)
SFM_SCHUR_BACK(sfm_schur_back_substitute_b10, 10, float)
SFM_SCHUR_BACK(sfm_schur_back_substitute_f64, 6, double)
SFM_SCHUR_BACK(sfm_schur_back_substitute_b10_f64, 10, double)
#undef SFM_SCHUR_BACK

#define SFM_BLOCK_JACOBI(NAME, B, T)                                                          \
  SFM_API int NAME(const void* U, const void* lam_diag_c, const void* Uk,                     \
                   const void* lam_diag_k, int C, void* Mc, void* Mk, void* stream) {         \
    return schur_block_jacobi<B, T>(U, lam_diag_c, Uk, lam_diag_k, C, Mc, Mk,                 \
                                    static_cast<cudaStream_t>(stream));                       \
  }
SFM_BLOCK_JACOBI(sfm_schur_block_jacobi, 6, float)
SFM_BLOCK_JACOBI(sfm_schur_block_jacobi_b10, 10, float)
SFM_BLOCK_JACOBI(sfm_schur_block_jacobi_f64, 6, double)
SFM_BLOCK_JACOBI(sfm_schur_block_jacobi_b10_f64, 10, double)
#undef SFM_BLOCK_JACOBI
