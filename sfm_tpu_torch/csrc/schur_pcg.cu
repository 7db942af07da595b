// Kernel K11: the matrix-free product with the reduced (camera + shared
// intrinsics) Schur system and its block-Jacobi preconditioned CG, the BA
// solve for more than BAConfig.use_dense_schur_below cameras.
//
// Replaces sfm_tpu/ba/schur.py::schur_matvec (:232: a = B x, the point-side
// segment sum W^T x, Vinv, W, the camera-side reduction of B^T (a - z) and
// the damping terms) and ::pcg_solve (:261: a lax.while_loop over CG steps,
// each a matvec, two dot products, the block-Jacobi apply and the axpys),
// which XLA ran as gathers, small batched einsums, scatters and one-hot
// matmuls, with the loop's condition on the device.
//
// sfm_schur_matvec: one thread per row of the per-point grouping
// (schur.py::coobs_pairs, the grouping K8-K10 walk): for the point's
// observations a_o = Jc_o x_c(o) + Jk_o xk, u = sum_o Jp_o^T a_o,
// v = Vinv_p u, and d_o = a_o - Jp_o v summed as Jc_o^T d_o into its
// camera's six entries and as Jk_o^T d_o into the four intrinsics entries;
// then Sx = lam_diag o x (+ Hreg_k xk on the intrinsics) + those sums. The
// sums are order-free fixed-point sums (sfm_common.cuh): the rows kernel
// runs once for every target's largest |term|, then, at the shifts that
// follow, once more to add (a per-block copy in shared memory, flushed with
// one global atomic per nonzero entry; the intrinsics warp-combined first),
// so Sx has the same bits every run. No (O, C) one-hot.
// sfm_pcg_init and sfm_pcg_step: one block each, over the flat (6C + 4)
// vectors (C <= a few thousand, so one block holds the whole vector and its
// dot products need no second pass). The step does alpha, the x and r
// updates, z = M r (one thread a camera: its 6x6 block of Mc; one thread
// the 4x4 Mk), r.z, r.r, beta and p; rz, |rhs|^2, r.r, an "active" flag and
// the iteration count stay in a small device state array. A step, and the
// matvec kernels given the flag, are no-ops once the flag is 0, which the
// step clears when |r| <= tol |rhs| or after `iters` steps: the reference's
// early exit at the same iteration, with no host sync inside the solve.
// Block sums are deterministic (sfm_common.cuh::sfm_block_sum).
//
// Every entry is templated on the camera block B (6, or 10 with per-camera
// intrinsics, schur.py:232's layout at 10C + 4) and on the island's scalar T
// (float, or double with BAConfig.f64_normal_equations: the vectors, the
// state and the dot products in double, the matvec's sums two words,
// sfm_common.cuh). At B = 10 the matvec adds U_extra x_c (schur.py:253-256:
// the per-camera intrinsics regularization, a part of U that the Jc
// products cannot rebuild); the camera sums of a block live in shared
// memory, WORDS x (BC + 4) x 8 bytes of 227 KB, while they fit (C up to
// 4,842 at B = 6 in float, 2,905 at B = 10, 2,420 and 1,452 in double:
// schur.py::max_cameras); above that the rows add straight into the global
// words with the same 64-bit integer atomics (the same bits), so C has no
// cap.
//
// What bounds it on the H100: memory. A matvec reads each observation's
// whitened Jacobians (13 x 2 floats), its camera and point ids and its slot
// in the grouping (~120 bytes) and each point's Vinv (36 bytes): at 600k
// observations and 60k points ~75 MB, ~22 us at 3.35 TB/s (the two passes
// read it twice); ~150 FLOP an observation is ~1.3 us of f32. The CG step moves a few (6C + 4)-vectors and
// the 36C floats of Mc: nothing; one block and its launch are its cost.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;    // matvec threads a block
constexpr int NB = 1024;   // the one block of the CG kernels

template <typename T>
__device__ __forceinline__ T eps() {
  return T(1e-10);
}
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }

// Sx = lam_diag o x (+ U_extra_c x_c on the cameras, + Hreg_k xk on the
// intrinsics) + the coupling sums.
template <int B, typename T>
__global__ void __launch_bounds__(NT) matvec_finish_kernel(
    const T* __restrict__ lam_diag_c, const T* __restrict__ lam_diag_k,
    const T* __restrict__ Hreg_k, const T* __restrict__ U_extra, const T* __restrict__ x, int C,
    const unsigned long long* __restrict__ gacc, const int* __restrict__ sh,
    const T* __restrict__ flag, T* __restrict__ Sx) {
  if (flag != nullptr && *flag == T(0)) return;
  const int i = blockIdx.x * NT + threadIdx.x;
  const int nB = B * C, n = nB + 4;
  if (i < nB) {
    T d = lam_diag_c[i] * x[i];
    if (U_extra != nullptr) {
      const int c = i / B, r = i % B;
      T u = T(0);
#pragma unroll
      for (int j = 0; j < B; ++j) u += U_extra[(size_t)c * B * B + r * B + j] * x[c * B + j];
      d += u;
    }
    Sx[i] = (T)((double)d + sfm_fx_value_t<T>(gacc, n, i, sh[i]));
  } else if (i < n) {
    const int k = i - nB;
    T h = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) h += Hreg_k[k * 4 + j] * x[nB + j];
    Sx[i] = (T)((double)(lam_diag_k[k] * x[i] + h) + sfm_fx_value_t<T>(gacc, n, i, sh[i]));
  }
}

// a_o = Jc_o xc + Jk_o xk for one observation (2 rows).
template <int B, typename T>
__device__ __forceinline__ void apply_b(const T* jc, const T* jk, const T* xc, const T* xk,
                                       T* a) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T ac = T(0), ak = T(0);
#pragma unroll
    for (int k = 0; k < B; ++k) ac += jc[r * B + k] * xc[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) ak += jk[r * 4 + k] * xk[k];
    a[r] = ac + ak;
  }
}

// SH: the block stages its sums in shared memory; otherwise they go to the
// global words directly (sfm_fx_target).
template <int B, typename T, bool ADD, bool SH>
__global__ void __launch_bounds__(NT) matvec_rows_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs, int C,
    const T* __restrict__ Vinv, const T* __restrict__ x, const T* __restrict__ flag,
    const int* __restrict__ sh, unsigned int* __restrict__ gmax,
    unsigned long long* __restrict__ gacc) {
  if (flag != nullptr && *flag == T(0)) return;  // the same for the whole block
  extern __shared__ unsigned long long s_stage[];  // C x B camera sums, then 4 intrinsics sums
  unsigned long long* s_acc = sfm_fx_target<ADD, SH>(s_stage, gmax, gacc);
  const int nB = B * C, n = nB + 4;
  if (SH) sfm_fx_stage_zero<T>(s_acc, n);
  __syncthreads();
  const int g = blockIdx.x * NT + threadIdx.x;
  SfmFxPart rk[4];
  if (g < G && perm_valid[(size_t)g * Vs]) {
    T xk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xk[k] = x[nB + k];
    const int* row = perm + (size_t)g * Vs;
    const uint8_t* ok = perm_valid + (size_t)g * Vs;
    T u[3] = {T(0), T(0), T(0)};
    for (int s = 0; s < Vs && ok[s]; ++s) {
      const int o = row[s];
      T a[2];
      apply_b<B, T>(Jc + (size_t)o * 2 * B, Jk + (size_t)o * 8, x + (size_t)obs_cam[o] * B, xk,
                    a);
      const T* jp = Jp + (size_t)o * 6;
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] += jp[i] * a[0] + jp[3 + i] * a[1];
    }
    const T* Vi = Vinv + (size_t)obs_point[row[0]] * 9;
    T v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = Vi[i * 3] * u[0] + Vi[i * 3 + 1] * u[1] + Vi[i * 3 + 2] * u[2];
    for (int s = 0; s < Vs && ok[s]; ++s) {
      const int o = row[s];
      const int c = obs_cam[o];
      const T* jc = Jc + (size_t)o * 2 * B;
      const T* jk = Jk + (size_t)o * 8;
      const T* jp = Jp + (size_t)o * 6;
      T a[2];
      apply_b<B, T>(jc, jk, x + (size_t)c * B, xk, a);
      const T d0 = a[0] - (jp[0] * v[0] + jp[1] * v[1] + jp[2] * v[2]);
      const T d1 = a[1] - (jp[3] * v[0] + jp[4] * v[1] + jp[5] * v[2]);
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const T t = jc[k] * d0 + jc[B + k] * d1;
        if (t != T(0)) sfm_fx_put<T, ADD>(s_acc, n, B * c + k, t, sh);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sfm_fx_part<T, ADD>(rk[k], jk[k] * d0 + jk[4 + k] * d1, ADD ? sh[nB + k] : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<T, ADD>(s_acc, n, nB + k, rk[k]);
  if (SH) {
    __syncthreads();
    sfm_fx_flush<T, ADD>(s_acc, n, gmax, gacc);
  }
}

// z = blockdiag(Mc, Mk) r, one thread a camera block (and one the 4x4 Mk).
template <int B, typename T>
__device__ __forceinline__ void precondition(const T* __restrict__ Mc,
                                             const T* __restrict__ Mk, const T* r, T* z,
                                             int C) {
  for (int c = threadIdx.x; c <= C; c += NB) {
    if (c < C) {
      const T* M = Mc + (size_t)c * B * B;
      const T* rc = r + B * c;
#pragma unroll
      for (int i = 0; i < B; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < B; ++j) s += M[i * B + j] * rc[j];
        z[B * c + i] = s;
      }
    } else {
      const T* rc = r + B * C;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < 4; ++j) s += Mk[i * 4 + j] * rc[j];
        z[B * C + i] = s;
      }
    }
  }
}

// state: [0] r.z, [1] |rhs|^2, [2] r.r, [3] active (1 or 0), [4] steps taken.
template <typename T>
__device__ __forceinline__ T still_active(T steps, int iters, T rr, T rhs2, T tol) {
  return (steps < (T)iters && t_sqrt(rr) > tol * t_sqrt(rhs2)) ? T(1) : T(0);
}

template <int B, typename T>
__global__ void __launch_bounds__(NB) pcg_init_kernel(
    const T* __restrict__ rhs, const T* __restrict__ Mc, const T* __restrict__ Mk,
    int C, int iters, T tol, T* __restrict__ x, T* __restrict__ r,
    T* __restrict__ z, T* __restrict__ p, T* __restrict__ state) {
  __shared__ T red[NB / 32][2];
  const int n = B * C + 4;
  for (int i = threadIdx.x; i < n; i += NB) {
    x[i] = T(0);
    r[i] = rhs[i];
  }
  __syncthreads();
  precondition<B, T>(Mc, Mk, r, z, C);
  __syncthreads();
  T v[2] = {T(0), T(0)};
  for (int i = threadIdx.x; i < n; i += NB) {
    p[i] = z[i];
    v[0] += r[i] * z[i];
    v[1] += r[i] * r[i];
  }
  sfm_block_sum<NB, 2>(v, red);
  if (threadIdx.x == 0) {
    state[0] = v[0];
    state[1] = v[1];
    state[2] = v[1];
    state[4] = T(0);
    state[3] = still_active<T>(T(0), iters, v[1], v[1], tol);
  }
}

template <int B, typename T>
__global__ void __launch_bounds__(NB) pcg_step_kernel(
    const T* __restrict__ Ap, const T* __restrict__ Mc, const T* __restrict__ Mk,
    int C, int iters, T tol, T* __restrict__ x, T* __restrict__ r,
    T* __restrict__ z, T* __restrict__ p, T* __restrict__ state) {
  __shared__ T red[NB / 32][2];
  if (state[3] == T(0)) return;  // converged or out of steps: the same for the block
  const int n = B * C + 4;
  T v[2] = {T(0), T(0)};
  for (int i = threadIdx.x; i < n; i += NB) v[0] += p[i] * Ap[i];
  sfm_block_sum<NB, 2>(v, red);
  const T rz = state[0];
  const T alpha = v[0] > eps<T>() ? rz / v[0] : T(0);
  for (int i = threadIdx.x; i < n; i += NB) {
    x[i] += alpha * p[i];
    r[i] -= alpha * Ap[i];
  }
  __syncthreads();
  precondition<B, T>(Mc, Mk, r, z, C);
  __syncthreads();
  v[0] = v[1] = T(0);
  for (int i = threadIdx.x; i < n; i += NB) {
    v[0] += r[i] * z[i];
    v[1] += r[i] * r[i];
  }
  sfm_block_sum<NB, 2>(v, red);
  const T beta = rz > eps<T>() ? v[0] / rz : T(0);
  for (int i = threadIdx.x; i < n; i += NB) p[i] = z[i] + beta * p[i];
  if (threadIdx.x == 0) {
    const T steps = state[4] + T(1);
    state[0] = v[0];
    state[2] = v[1];
    state[4] = steps;
    state[3] = still_active<T>(steps, iters, v[1], state[1], tol);
  }
}

// fx_max, fx_sh: n int32 each, fx_acc: WORDS x n uint64, n = BC + 4.
template <int B, typename T>
int schur_matvec(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                 const void* obs_point, const void* perm, const void* perm_valid,
                 const void* Vinv, const void* lam_diag_c, const void* lam_diag_k,
                 const void* Hreg_k, const void* x, int C, int G, int Vs, int in_shared,
                 const void* flag, void* Sx, void* fx_max, void* fx_sh, void* fx_acc,
                 const void* U_extra, cudaStream_t st) {
  const int n = B * C + 4;
  const T* fl = static_cast<const T*>(flag);
  unsigned int* gmax = static_cast<unsigned int*>(fx_max);
  int* sh = static_cast<int*>(fx_sh);
  unsigned long long* gacc = static_cast<unsigned long long*>(fx_acc);
  cudaError_t e = cudaMemsetAsync(gmax, 0, (size_t)n * sizeof(unsigned int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(gacc, 0, (size_t)SfmFx<T>::WORDS * n * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    const int blocks = (G + NT - 1) / NT;
#define MATVEC_ROWS_ARGS                                                                     \
  static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),           \
      static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),                  \
      static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), G, Vs, C,      \
      static_cast<const T*>(Vinv), static_cast<const T*>(x), fl, sh, gmax, gacc
    if (in_shared) {
      const size_t smem = (size_t)SfmFx<T>::WORDS * n * sizeof(unsigned long long);
      e = cudaFuncSetAttribute(matvec_rows_kernel<B, T, false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(matvec_rows_kernel<B, T, true, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      matvec_rows_kernel<B, T, false, true><<<blocks, NT, smem, st>>>(MATVEC_ROWS_ARGS);
      sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, (double)G * Vs, fl,
                                                               sh);
      matvec_rows_kernel<B, T, true, true><<<blocks, NT, smem, st>>>(MATVEC_ROWS_ARGS);
    } else {
      matvec_rows_kernel<B, T, false, false><<<blocks, NT, 0, st>>>(MATVEC_ROWS_ARGS);
      sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, (double)G * Vs, fl,
                                                               sh);
      matvec_rows_kernel<B, T, true, false><<<blocks, NT, 0, st>>>(MATVEC_ROWS_ARGS);
    }
#undef MATVEC_ROWS_ARGS
  } else {
    sfm_fx_shift_kernel<T><<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, 1.0, fl, sh);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_finish_kernel<B, T><<<(n + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const T*>(lam_diag_c), static_cast<const T*>(lam_diag_k),
      static_cast<const T*>(Hreg_k), static_cast<const T*>(U_extra), static_cast<const T*>(x),
      C, gacc, sh, fl, static_cast<T*>(Sx));
  return static_cast<int>(cudaGetLastError());
}

template <int B, typename T>
int pcg_init(const void* rhs, const void* Mc, const void* Mk, int C, int iters, T tol, void* x,
             void* r, void* z, void* p, void* state, cudaStream_t st) {
  pcg_init_kernel<B, T><<<1, NB, 0, st>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(Mc), static_cast<const T*>(Mk), C,
      iters, tol, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(z),
      static_cast<T*>(p), static_cast<T*>(state));
  return static_cast<int>(cudaGetLastError());
}

template <int B, typename T>
int pcg_step(const void* Ap, const void* Mc, const void* Mk, int C, int iters, T tol, void* x,
             void* r, void* z, void* p, void* state, cudaStream_t st) {
  pcg_step_kernel<B, T><<<1, NB, 0, st>>>(
      static_cast<const T*>(Ap), static_cast<const T*>(Mc), static_cast<const T*>(Mk), C,
      iters, tol, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(z),
      static_cast<T*>(p), static_cast<T*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SFM_API int sfm_schur_matvec(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                             const void* obs_point, const void* perm, const void* perm_valid,
                             const void* Vinv, const void* lam_diag_c, const void* lam_diag_k,
                             const void* Hreg_k, const void* x, int C, int G, int Vs,
                             int in_shared, const void* flag, void* Sx, void* fx_max,
                             void* fx_sh, void* fx_acc, void* stream) {
  return schur_matvec<6, float>(Jc, Jk, Jp, obs_cam, obs_point, perm, perm_valid, Vinv,
                                lam_diag_c, lam_diag_k, Hreg_k, x, C, G, Vs, in_shared, flag,
                                Sx, fx_max, fx_sh, fx_acc, nullptr,
                                static_cast<cudaStream_t>(stream));
}

// The other routes: U_extra (C, B, B) or null.
#define SFM_SCHUR_MATVEC(NAME, B, T)                                                          \
  SFM_API int NAME(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,       \
                   const void* obs_point, const void* perm, const void* perm_valid,           \
                   const void* Vinv, const void* lam_diag_c, const void* lam_diag_k,          \
                   const void* Hreg_k, const void* x, int C, int G, int Vs, int in_shared,    \
                   const void* flag, void* Sx, void* fx_max, void* fx_sh, void* fx_acc,       \
                   const void* U_extra, void* stream) {                                       \
    return schur_matvec<B, T>(Jc, Jk, Jp, obs_cam, obs_point, perm, perm_valid, Vinv,         \
                              lam_diag_c, lam_diag_k, Hreg_k, x, C, G, Vs, in_shared, flag,   \
                              Sx, fx_max, fx_sh, fx_acc, U_extra,                             \
                              static_cast<cudaStream_t>(stream));                             \
  }
SFM_SCHUR_MATVEC(sfm_schur_matvec_b10, 10, float)
SFM_SCHUR_MATVEC(sfm_schur_matvec_f64, 6, double)
SFM_SCHUR_MATVEC(sfm_schur_matvec_b10_f64, 10, double)
#undef SFM_SCHUR_MATVEC

// The default route takes tol as a float, the others as a double.
#define SFM_PCG(NAME, FN, B, T, TOL)                                                          \
  SFM_API int NAME(const void* v, const void* Mc, const void* Mk, int C, int iters, TOL tol,  \
                   void* x, void* r, void* z, void* p, void* state, void* stream) {           \
    return FN<B, T>(v, Mc, Mk, C, iters, (T)tol, x, r, z, p, state,                           \
                    static_cast<cudaStream_t>(stream));                                       \
  }
SFM_PCG(sfm_pcg_init, pcg_init, 6, float, float)
SFM_PCG(sfm_pcg_step, pcg_step, 6, float, float)
SFM_PCG(sfm_pcg_init_b10, pcg_init, 10, float, double)
SFM_PCG(sfm_pcg_step_b10, pcg_step, 10, float, double)
SFM_PCG(sfm_pcg_init_f64, pcg_init, 6, double, double)
SFM_PCG(sfm_pcg_step_f64, pcg_step, 6, double, double)
SFM_PCG(sfm_pcg_init_b10_f64, pcg_init, 10, double, double)
SFM_PCG(sfm_pcg_step_b10_f64, pcg_step, 10, double, double)
#undef SFM_PCG
