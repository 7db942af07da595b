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
constexpr float kEps = 1e-10f;

// Sx = lam_diag o x (+ Hreg_k xk on the intrinsics) + the coupling sums.
__global__ void __launch_bounds__(NT) matvec_finish_kernel(
    const float* __restrict__ lam_diag_c, const float* __restrict__ lam_diag_k,
    const float* __restrict__ Hreg_k, const float* __restrict__ x, int C,
    const unsigned long long* __restrict__ gacc, const int* __restrict__ sh,
    const float* __restrict__ flag, float* __restrict__ Sx) {
  if (flag != nullptr && *flag == 0.f) return;
  const int i = blockIdx.x * NT + threadIdx.x;
  const int n6 = 6 * C;
  if (i < n6) {
    Sx[i] = (float)((double)(lam_diag_c[i] * x[i]) + sfm_fx_value(gacc[i], sh[i]));
  } else if (i < n6 + 4) {
    const int k = i - n6;
    float h = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) h += Hreg_k[k * 4 + j] * x[n6 + j];
    Sx[i] = (float)((double)(lam_diag_k[k] * x[i] + h) + sfm_fx_value(gacc[i], sh[i]));
  }
}

// a_o = Jc_o xc + Jk_o xk for one observation (2 rows).
__device__ __forceinline__ void apply_b(const float* jc, const float* jk, const float* xc,
                                       const float* xk, float* a) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ac = 0.f, ak = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) ac += jc[r * 6 + k] * xc[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) ak += jk[r * 4 + k] * xk[k];
    a[r] = ac + ak;
  }
}

template <bool ADD>
__global__ void __launch_bounds__(NT) matvec_rows_kernel(
    const float* __restrict__ Jc, const float* __restrict__ Jk, const float* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int G, int Vs, int C,
    const float* __restrict__ Vinv, const float* __restrict__ x,
    const float* __restrict__ flag, const int* __restrict__ sh,
    unsigned int* __restrict__ gmax, unsigned long long* __restrict__ gacc) {
  if (flag != nullptr && *flag == 0.f) return;  // the same for the whole block
  extern __shared__ unsigned long long s_acc[];  // C x 6 camera sums, then 4 intrinsics sums
  const int n6 = 6 * C;
  sfm_fx_stage_zero(s_acc, n6 + 4);
  __syncthreads();
  const int g = blockIdx.x * NT + threadIdx.x;
  SfmFxPart rk[4];
  if (g < G && perm_valid[(size_t)g * Vs]) {
    float xk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) xk[k] = x[n6 + k];
    const int* row = perm + (size_t)g * Vs;
    const uint8_t* ok = perm_valid + (size_t)g * Vs;
    float u[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < Vs && ok[s]; ++s) {
      const int o = row[s];
      float a[2];
      apply_b(Jc + (size_t)o * 12, Jk + (size_t)o * 8, x + (size_t)obs_cam[o] * 6, xk, a);
      const float* jp = Jp + (size_t)o * 6;
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] += jp[i] * a[0] + jp[3 + i] * a[1];
    }
    const float* Vi = Vinv + (size_t)obs_point[row[0]] * 9;
    float v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = Vi[i * 3] * u[0] + Vi[i * 3 + 1] * u[1] + Vi[i * 3 + 2] * u[2];
    for (int s = 0; s < Vs && ok[s]; ++s) {
      const int o = row[s];
      const int c = obs_cam[o];
      const float* jc = Jc + (size_t)o * 12;
      const float* jk = Jk + (size_t)o * 8;
      const float* jp = Jp + (size_t)o * 6;
      float a[2];
      apply_b(jc, jk, x + (size_t)c * 6, xk, a);
      const float d0 = a[0] - (jp[0] * v[0] + jp[1] * v[1] + jp[2] * v[2]);
      const float d1 = a[1] - (jp[3] * v[0] + jp[4] * v[1] + jp[5] * v[2]);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float t = jc[k] * d0 + jc[6 + k] * d1;
        if (t != 0.f) sfm_fx_put<ADD>(s_acc, 6 * c + k, t, sh);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sfm_fx_part<ADD>(rk[k], jk[k] * d0 + jk[4 + k] * d1, ADD ? sh[n6 + k] : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<ADD>(s_acc, n6 + k, rk[k]);
  __syncthreads();
  sfm_fx_flush<ADD>(s_acc, n6 + 4, gmax, gacc);
}

// z = blockdiag(Mc, Mk) r, one thread a camera block (and one the 4x4 Mk).
__device__ __forceinline__ void precondition(const float* __restrict__ Mc,
                                             const float* __restrict__ Mk, const float* r,
                                             float* z, int C) {
  for (int c = threadIdx.x; c <= C; c += NB) {
    if (c < C) {
      const float* M = Mc + (size_t)c * 36;
      const float* rc = r + 6 * c;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) s += M[i * 6 + j] * rc[j];
        z[6 * c + i] = s;
      }
    } else {
      const float* rc = r + 6 * C;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += Mk[i * 4 + j] * rc[j];
        z[6 * C + i] = s;
      }
    }
  }
}

// state: [0] r.z, [1] |rhs|^2, [2] r.r, [3] active (1 or 0), [4] steps taken.
__device__ __forceinline__ float still_active(float steps, int iters, float rr, float rhs2,
                                              float tol) {
  return (steps < (float)iters && sqrtf(rr) > tol * sqrtf(rhs2)) ? 1.f : 0.f;
}

__global__ void __launch_bounds__(NB) pcg_init_kernel(
    const float* __restrict__ rhs, const float* __restrict__ Mc, const float* __restrict__ Mk,
    int C, int iters, float tol, float* __restrict__ x, float* __restrict__ r,
    float* __restrict__ z, float* __restrict__ p, float* __restrict__ state) {
  __shared__ float red[NB / 32][2];
  const int n = 6 * C + 4;
  for (int i = threadIdx.x; i < n; i += NB) {
    x[i] = 0.f;
    r[i] = rhs[i];
  }
  __syncthreads();
  precondition(Mc, Mk, r, z, C);
  __syncthreads();
  float v[2] = {0.f, 0.f};
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
    state[4] = 0.f;
    state[3] = still_active(0.f, iters, v[1], v[1], tol);
  }
}

__global__ void __launch_bounds__(NB) pcg_step_kernel(
    const float* __restrict__ Ap, const float* __restrict__ Mc, const float* __restrict__ Mk,
    int C, int iters, float tol, float* __restrict__ x, float* __restrict__ r,
    float* __restrict__ z, float* __restrict__ p, float* __restrict__ state) {
  __shared__ float red[NB / 32][2];
  if (state[3] == 0.f) return;  // converged or out of steps: the same for the block
  const int n = 6 * C + 4;
  float v[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += NB) v[0] += p[i] * Ap[i];
  sfm_block_sum<NB, 2>(v, red);
  const float rz = state[0];
  const float alpha = v[0] > kEps ? rz / v[0] : 0.f;
  for (int i = threadIdx.x; i < n; i += NB) {
    x[i] += alpha * p[i];
    r[i] -= alpha * Ap[i];
  }
  __syncthreads();
  precondition(Mc, Mk, r, z, C);
  __syncthreads();
  v[0] = v[1] = 0.f;
  for (int i = threadIdx.x; i < n; i += NB) {
    v[0] += r[i] * z[i];
    v[1] += r[i] * r[i];
  }
  sfm_block_sum<NB, 2>(v, red);
  const float beta = rz > kEps ? v[0] / rz : 0.f;
  for (int i = threadIdx.x; i < n; i += NB) p[i] = z[i] + beta * p[i];
  if (threadIdx.x == 0) {
    const float steps = state[4] + 1.f;
    state[0] = v[0];
    state[2] = v[1];
    state[4] = steps;
    state[3] = still_active(steps, iters, v[1], state[1], tol);
  }
}

}  // namespace

SFM_API int sfm_schur_matvec(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                             const void* obs_point, const void* perm, const void* perm_valid,
                             const void* Vinv, const void* lam_diag_c, const void* lam_diag_k,
                             const void* Hreg_k, const void* x, int C, int G, int Vs,
                             const void* flag, void* Sx, void* fx_max, void* fx_sh,
                             void* fx_acc, void* stream) {
  // fx_max, fx_sh: n int32 each, fx_acc: n uint64, n = 6C + 4.
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 6 * C + 4;
  const float* fl = static_cast<const float*>(flag);
  unsigned int* gmax = static_cast<unsigned int*>(fx_max);
  int* sh = static_cast<int*>(fx_sh);
  unsigned long long* gacc = static_cast<unsigned long long*>(fx_acc);
  cudaError_t e = cudaMemsetAsync(gmax, 0, (size_t)n * sizeof(unsigned int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(gacc, 0, (size_t)n * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    const size_t smem = (size_t)n * sizeof(unsigned long long);
    e = cudaFuncSetAttribute(matvec_rows_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(matvec_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = (G + NT - 1) / NT;
#define MATVEC_ROWS_ARGS                                                                \
  static_cast<const float*>(Jc), static_cast<const float*>(Jk),                         \
      static_cast<const float*>(Jp), static_cast<const int*>(obs_cam),                  \
      static_cast<const int*>(obs_point), static_cast<const int*>(perm),                \
      static_cast<const uint8_t*>(perm_valid), G, Vs, C, static_cast<const float*>(Vinv), \
      static_cast<const float*>(x), fl, sh, gmax, gacc
    matvec_rows_kernel<false><<<blocks, NT, smem, st>>>(MATVEC_ROWS_ARGS);
    sfm_fx_shift_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, (double)G * Vs, fl, sh);
    matvec_rows_kernel<true><<<blocks, NT, smem, st>>>(MATVEC_ROWS_ARGS);
#undef MATVEC_ROWS_ARGS
  } else {
    sfm_fx_shift_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(gmax, n, 1.0, fl, sh);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_finish_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(lam_diag_c), static_cast<const float*>(lam_diag_k),
      static_cast<const float*>(Hreg_k), static_cast<const float*>(x), C, gacc, sh, fl,
      static_cast<float*>(Sx));
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_pcg_init(const void* rhs, const void* Mc, const void* Mk, int C, int iters,
                         float tol, void* x, void* r, void* z, void* p, void* state,
                         void* stream) {
  pcg_init_kernel<<<1, NB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rhs), static_cast<const float*>(Mc),
      static_cast<const float*>(Mk), C, iters, tol, static_cast<float*>(x),
      static_cast<float*>(r), static_cast<float*>(z), static_cast<float*>(p),
      static_cast<float*>(state));
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_pcg_step(const void* Ap, const void* Mc, const void* Mk, int C, int iters,
                         float tol, void* x, void* r, void* z, void* p, void* state,
                         void* stream) {
  pcg_step_kernel<<<1, NB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Ap), static_cast<const float*>(Mc),
      static_cast<const float*>(Mk), C, iters, tol, static_cast<float*>(x),
      static_cast<float*>(r), static_cast<float*>(z), static_cast<float*>(p),
      static_cast<float*>(state));
  return static_cast<int>(cudaGetLastError());
}
