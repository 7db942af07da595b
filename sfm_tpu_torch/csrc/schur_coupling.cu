// Kernel K10: the point coupling of the dense reduced (Schur) system.
//
// Replaces the assembly in sfm_tpu/ba/schur.py::dense_schur_direct (:348-418):
// there the per-slot blocks are scattered onto cameras by one-hot matmuls and
// the camera-pair coupling sum_p sum_{a,b in obs(p)} W_a V_p^-1 W_b^T is one
// (3P' x 6C)^T (3P' x 6C) matmul (an MXU trick), and the camera blocks are one
// scatter (:392). Here the wrapper zeroes S and writes Uk + diag(lambda_k);
// the kernels add the camera blocks U_c + diag(lambda D_c), subtract the
// coupling and add the intrinsics row/column, in place:
//   S[cam_a, cam_b] -= M_a Vinv_p M_b^T         (M_o = Jc_o^T Jp_o, 6 x 3)
//   S[cam_a, k]     += Jc_a^T Jk_a - M_a Vinv_p Wk_p^T  (Wk_p = sum_a Jk_a^T Jp_a)
//   S[k, k]         -= Wk_p Vinv_p Wk_p^T
// with the transposed blocks mirrored, so S comes out symmetric.
//
// Design (simple first): one warp per row of the per-point grouping
// (schur.py::coobs_pairs; a point's valid observations are a leading run of
// slots). Lanes take the unordered slot pairs a <= b and add the 6x6 block (and
// its transpose when a != b) with global atomics; lanes then take slots for the
// k column. The S_kk terms of a block's 8 points meet in shared memory first.
// The atomics are order-free 64-bit fixed-point sums (sfm_common.cuh), so S
// has the same bits every run. Their bound needs no first pass: with d_r^2
// the row's damped diagonal (U_ii + lambda D_ii, or Uk_jj + lambda_k), every
// term of entry (r, s) is at most sqrt(q_a,r q_b,s) (Cauchy-Schwarz, as
// Jp_a Vinv_p Jp_a^T <= I), and those add up to at most d_r d_s (2 d_r d_s on
// the k column). The shift maps 4 d_r d_s to 2^52, leaving 2^11 of headroom
// for points with two observations in one camera and for the rounding of
// Vinv; a term past 2^62 all the same (or a non-finite one) makes the whole S
// NaN, which the LM loop rejects like any failed solve. A last kernel rounds
// every entry to float once and adds the camera blocks.
//
// What bounds it on the H100: atomics into S. The 100-camera, 200k-observation
// scene has ~20k points x ~10 observations: ~1.1M slot pairs x 36 atomics onto
// 360k distinct addresses (~200 each), and ~200 FLOP per pair.
#include "sfm_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;

// M = Jc^T Jp (6 x 3) of observation o.
__device__ __forceinline__ void coupling_block(const float* __restrict__ Jc,
                                               const float* __restrict__ Jp, int o,
                                               float M[6][3]) {
  const float* c = Jc + (size_t)o * 12;
  const float* p = Jp + (size_t)o * 6;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = c[i] * p[j] + c[6 + i] * p[3 + j];
}

// d_r's exponent (d_r < 2^e) for every row of S: the damped camera diagonal,
// then the intrinsics block's diagonal as the wrapper wrote it into S.
__global__ void __launch_bounds__(NT) row_scale_kernel(const float* __restrict__ U,
                                                       const float* __restrict__ lam_diag_c,
                                                       const float* __restrict__ S, int C,
                                                       int* __restrict__ er) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const int n = 6 * C + 4;
  if (r >= n) return;
  const float d2 = r < 6 * C ? U[(size_t)(r / 6) * 36 + (r % 6) * 7] + lam_diag_c[r]
                             : S[(size_t)r * n + r];
  int e = 0;
  if (!(d2 <= 3.0e38f)) {
    e = SFM_FX_BAD;
  } else {
    frexp(sqrt(fmax((double)d2, 0.0)), &e);
  }
  er[r] = e;
}

// x added to entry (r, s) as a fixed-point integer at that entry's shift.
__device__ __forceinline__ void add_entry(unsigned long long* __restrict__ acc,
                                          const int* __restrict__ er, int* __restrict__ bad,
                                          size_t n, size_t r, size_t s, float x) {
  const int a = er[r], b = er[s];
  if (a == SFM_FX_BAD || b == SFM_FX_BAD) return;  // the entry comes out NaN
  const double v = ldexp((double)x, 50 - a - b);
  if (!(fabs(v) < 4.611686018427388e18)) {  // 2^62: past the bound, or not finite
    atomicOr(bad, 1);
    return;
  }
  const long long q = __double2ll_rn(v);
  if (q != 0) atomicAdd(&acc[r * n + s], static_cast<unsigned long long>(q));
}

__global__ void __launch_bounds__(NT) schur_coupling_kernel(
    const float* __restrict__ Jc, const float* __restrict__ Jk,
    const float* __restrict__ Jp, const int* __restrict__ obs_cam,
    const int* __restrict__ obs_point, const float* __restrict__ Vinv,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int C, int G,
    int Vs, const int* __restrict__ er, int* __restrict__ bad,
    unsigned long long* __restrict__ acc) {
  extern __shared__ int sslot[];  // WARPS x Vs observation ids, then WARPS x Vs cams
  __shared__ unsigned long long s_kk[16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + warp;
  const size_t n = (size_t)6 * C + 4;
  const size_t kc = (size_t)6 * C;
  if (threadIdx.x < 16) s_kk[threadIdx.x] = 0ull;
  int* so = sslot + warp * Vs;
  int* sc = sslot + WARPS * Vs + warp * Vs;

  int nv = 0;
  if (g < G) {
    for (int s0 = 0; s0 < Vs; s0 += 32) {
      const int s = s0 + lane;
      const bool ok = s < Vs && perm_valid[(size_t)g * Vs + s];
      if (ok) {
        const int o = perm[(size_t)g * Vs + s];
        so[s] = o;
        sc[s] = obs_cam[o];
      }
      nv += __popc(__ballot_sync(0xffffffffu, ok));
    }
  }
  __syncthreads();  // s_kk zeroed, slot lists visible to the warp
  if (nv > 0) {
    const int p = obs_point[so[0]];
    float Vi[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Vi[i][j] = Vinv[(size_t)p * 9 + i * 3 + j];

    // Coupling: unordered slot pairs (a <= b).
    for (int k = lane; k < nv * nv; k += 32) {
      const int a = k / nv, b = k % nv;
      if (b < a) continue;
      float Ma[6][3], Mb[6][3], A[6][3];
      coupling_block(Jc, Jp, so[a], Ma);
      coupling_block(Jc, Jp, so[b], Mb);
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          A[i][j] = Ma[i][0] * Vi[0][j] + Ma[i][1] * Vi[1][j] + Ma[i][2] * Vi[2][j];
      const size_t ca = (size_t)6 * sc[a], cb = (size_t)6 * sc[b];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float x = A[i][0] * Mb[j][0] + A[i][1] * Mb[j][1] + A[i][2] * Mb[j][2];
          add_entry(acc, er, bad, n, ca + i, cb + j, -x);
          if (a != b) add_entry(acc, er, bad, n, cb + j, ca + i, -x);
        }
    }

    // Wk_p = sum_a Jk_a^T Jp_a (4 x 3), warp-reduced.
    float wk[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) wk[e] = 0.f;
    for (int a = lane; a < nv; a += 32) {
      const float* jk = Jk + (size_t)so[a] * 8;
      const float* jp = Jp + (size_t)so[a] * 6;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) wk[i * 3 + j] += jk[i] * jp[j] + jk[4 + i] * jp[3 + j];
    }
#pragma unroll
    for (int e = 0; e < 12; ++e)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wk[e] += __shfl_xor_sync(0xffffffffu, wk[e], off);
    // AkT = Vinv Wk^T (3 x 4).
    float AkT[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        AkT[i][j] = Vi[i][0] * wk[j * 3] + Vi[i][1] * wk[j * 3 + 1] + Vi[i][2] * wk[j * 3 + 2];

    // k column: Jc_a^T Jk_a - M_a AkT per slot.
    for (int a = lane; a < nv; a += 32) {
      const int o = so[a];
      float Ma[6][3];
      coupling_block(Jc, Jp, o, Ma);
      const float* jc = Jc + (size_t)o * 12;
      const float* jk = Jk + (size_t)o * 8;
      const size_t ca = (size_t)6 * sc[a];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = jc[i] * jk[j] + jc[6 + i] * jk[4 + j] -
                          (Ma[i][0] * AkT[0][j] + Ma[i][1] * AkT[1][j] + Ma[i][2] * AkT[2][j]);
          add_entry(acc, er, bad, n, ca + i, kc + j, x);
          add_entry(acc, er, bad, n, kc + j, ca + i, x);
        }
    }
    if (lane < 16) {
      const int i = lane / 4, j = lane % 4;
      const float x = wk[i * 3] * AkT[0][j] + wk[i * 3 + 1] * AkT[1][j] + wk[i * 3 + 2] * AkT[2][j];
      const int ea = er[kc + i], eb = er[kc + j];
      const double v = ldexp(-(double)x, 50 - ea - eb);
      if (ea == SFM_FX_BAD || eb == SFM_FX_BAD) {
      } else if (!(fabs(v) < 4.611686018427388e18)) {
        atomicOr(bad, 1);
      } else {
        const long long q = __double2ll_rn(v);
        if (q != 0) atomicAdd(&s_kk[lane], static_cast<unsigned long long>(q));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 16 && s_kk[threadIdx.x] != 0ull)
    atomicAdd(&acc[(kc + threadIdx.x / 4) * n + kc + threadIdx.x % 4], s_kk[threadIdx.x]);
}

// S = (what the wrapper wrote) + camera blocks U_c + diag(lambda D_c) + the
// coupling sums, rounded to float once; all NaN if a term fell out of bounds.
__global__ void __launch_bounds__(NT) schur_finish_kernel(
    const unsigned long long* __restrict__ acc, const int* __restrict__ er,
    const int* __restrict__ bad, const float* __restrict__ U,
    const float* __restrict__ lam_diag_c, int C, float* __restrict__ S) {
  const size_t n = (size_t)6 * C + 4;
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= n * n) return;
  const size_t r = e / n, s = e % n;
  double v = S[e];
  if (r < (size_t)6 * C && r / 6 == s / 6) {
    const size_t c = r / 6, i = r % 6, j = s % 6;
    v += (double)(U[c * 36 + i * 6 + j] + (i == j ? lam_diag_c[6 * c + i] : 0.f));
  }
  const int a = er[r], b = er[s];
  if (*bad || a == SFM_FX_BAD || b == SFM_FX_BAD) {
    v = __longlong_as_double(0x7ff8000000000000ll);
  } else {
    v += ldexp(static_cast<double>(static_cast<long long>(acc[e])), a + b - 50);
  }
  S[e] = (float)v;
}

}  // namespace

SFM_API int sfm_schur_coupling(const void* Jc, const void* Jk, const void* Jp,
                               const void* obs_cam, const void* obs_point,
                               const void* Vinv, const void* perm, const void* perm_valid,
                               const void* U, const void* lam_diag_c, int C, int G, int Vs,
                               void* S, void* fx_acc, void* fx_row, void* stream) {
  // fx_acc: n x n uint64, fx_row: n + 1 int32 (the rows' exponents, then the
  // out-of-bounds flag), n = 6C + 4.
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)6 * C + 4;
  int* er = static_cast<int*>(fx_row);
  int* bad = er + n;
  unsigned long long* acc = static_cast<unsigned long long*>(fx_acc);
  cudaError_t e = cudaMemsetAsync(acc, 0, n * n * sizeof(unsigned long long), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_scale_kernel<<<(int)((n + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const float*>(U), static_cast<const float*>(lam_diag_c),
      static_cast<const float*>(S), C, er);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    const size_t smem = (size_t)2 * WARPS * Vs * sizeof(int);
    e = cudaFuncSetAttribute(schur_coupling_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    schur_coupling_kernel<<<(G + WARPS - 1) / WARPS, NT, smem, st>>>(
        static_cast<const float*>(Jc), static_cast<const float*>(Jk),
        static_cast<const float*>(Jp), static_cast<const int*>(obs_cam),
        static_cast<const int*>(obs_point), static_cast<const float*>(Vinv),
        static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), C, G, Vs, er,
        bad, acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  schur_finish_kernel<<<(int)((n * n + NT - 1) / NT), NT, 0, st>>>(
      acc, er, bad, static_cast<const float*>(U), static_cast<const float*>(lam_diag_c), C,
      static_cast<float*>(S));
  return static_cast<int>(cudaGetLastError());
}
