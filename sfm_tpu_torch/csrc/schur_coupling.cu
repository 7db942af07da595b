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
// Templated on the camera block B (6, or 10 with per-camera intrinsics: S is
// (10C + 4)^2) and on the island's scalar T (float, or double with
// BAConfig.f64_normal_equations: the entries' sums take two words,
// sfm_common.cuh, at a shift 32 higher; S comes out double for cuSOLVER's
// f64 Cholesky). The Cauchy-Schwarz bound holds at any B: it only uses the
// damped diagonal of the row and the column.
//
// What bounds it on the H100: atomics into S. The 100-camera, 200k-observation
// scene has ~20k points x ~10 observations: ~1.1M slot pairs x 36 atomics onto
// 360k distinct addresses (~200 each), and ~200 FLOP per pair.
#include "sfm_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;

// The fixed point of an entry: x * 2^(SHIFT - e_r - e_s); a term past LIMIT
// (or a non-finite one) makes S NaN. The double's two words keep the same
// headroom in their hi word.
template <typename T>
struct Fix;
template <>
struct Fix<float> {
  static constexpr int SHIFT = 50;
  static constexpr double LIMIT = 4.611686018427388e18;  // 2^62
  static constexpr float DIAG_MAX = 3.0e38f;
};
template <>
struct Fix<double> {
  static constexpr int SHIFT = 82;
  static constexpr double LIMIT = 1.9807040628566084e28;  // 2^94
  static constexpr double DIAG_MAX = 1e300;
};

// M = Jc^T Jp (B x 3) of observation o.
template <int B, typename T>
__device__ __forceinline__ void coupling_block(const T* __restrict__ Jc,
                                               const T* __restrict__ Jp, int o, T M[B][3]) {
  const T* c = Jc + (size_t)o * 2 * B;
  const T* p = Jp + (size_t)o * 6;
#pragma unroll
  for (int i = 0; i < B; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = c[i] * p[j] + c[B + i] * p[3 + j];
}

// d_r's exponent (d_r < 2^e) for every row of S: the damped camera diagonal,
// then the intrinsics block's diagonal as the wrapper wrote it into S.
template <int B, typename T>
__global__ void __launch_bounds__(NT) row_scale_kernel(const T* __restrict__ U,
                                                       const T* __restrict__ lam_diag_c,
                                                       const T* __restrict__ S, int C,
                                                       int* __restrict__ er) {
  const int r = blockIdx.x * NT + threadIdx.x;
  const int n = B * C + 4;
  if (r >= n) return;
  const T d2 = r < B * C ? U[(size_t)(r / B) * B * B + (r % B) * (B + 1)] + lam_diag_c[r]
                         : S[(size_t)r * n + r];
  int e = 0;
  if (!(d2 <= Fix<T>::DIAG_MAX)) {
    e = SFM_FX_BAD;
  } else {
    frexp(sqrt(fmax((double)d2, 0.0)), &e);
  }
  er[r] = e;
}

// x added to entry (r, s) as a fixed-point integer at that entry's shift
// (nn = n x n: the second word's offset).
template <typename T>
__device__ __forceinline__ void add_entry(unsigned long long* __restrict__ acc,
                                          const int* __restrict__ er, int* __restrict__ bad,
                                          size_t n, size_t r, size_t s, T x) {
  const int a = er[r], b = er[s];
  if (a == SFM_FX_BAD || b == SFM_FX_BAD) return;  // the entry comes out NaN
  const double v = ldexp((double)x, Fix<T>::SHIFT - a - b);
  if (!(fabs(v) < Fix<T>::LIMIT)) {  // past the bound, or not finite
    atomicOr(bad, 1);
    return;
  }
  sfm_fx_add_q<T>(acc, n * n, r * n + s, sfm_fx_words<T>(v));
}

template <int B, typename T>
__global__ void __launch_bounds__(NT) schur_coupling_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk,
    const T* __restrict__ Jp, const int* __restrict__ obs_cam,
    const int* __restrict__ obs_point, const T* __restrict__ Vinv,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid, int C, int G,
    int Vs, const int* __restrict__ er, int* __restrict__ bad,
    unsigned long long* __restrict__ acc) {
  constexpr int W = SfmFx<T>::WORDS;
  extern __shared__ int sslot[];  // WARPS x Vs observation ids, then WARPS x Vs cams
  __shared__ unsigned long long s_kk[16 * W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + warp;
  const size_t n = (size_t)B * C + 4;
  const size_t kc = (size_t)B * C;
  if (threadIdx.x < 16 * W) s_kk[threadIdx.x] = 0ull;
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
    T Vi[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Vi[i][j] = Vinv[(size_t)p * 9 + i * 3 + j];

    // Coupling: unordered slot pairs (a <= b).
    for (int k = lane; k < nv * nv; k += 32) {
      const int a = k / nv, b = k % nv;
      if (b < a) continue;
      T Ma[B][3], Mb[B][3], A[B][3];
      coupling_block<B, T>(Jc, Jp, so[a], Ma);
      coupling_block<B, T>(Jc, Jp, so[b], Mb);
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          A[i][j] = Ma[i][0] * Vi[0][j] + Ma[i][1] * Vi[1][j] + Ma[i][2] * Vi[2][j];
      const size_t ca = (size_t)B * sc[a], cb = (size_t)B * sc[b];
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const T x = A[i][0] * Mb[j][0] + A[i][1] * Mb[j][1] + A[i][2] * Mb[j][2];
          add_entry<T>(acc, er, bad, n, ca + i, cb + j, -x);
          if (a != b) add_entry<T>(acc, er, bad, n, cb + j, ca + i, -x);
        }
    }

    // Wk_p = sum_a Jk_a^T Jp_a (4 x 3), warp-reduced.
    T wk[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) wk[e] = T(0);
    for (int a = lane; a < nv; a += 32) {
      const T* jk = Jk + (size_t)so[a] * 8;
      const T* jp = Jp + (size_t)so[a] * 6;
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
    T AkT[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        AkT[i][j] = Vi[i][0] * wk[j * 3] + Vi[i][1] * wk[j * 3 + 1] + Vi[i][2] * wk[j * 3 + 2];

    // k column: Jc_a^T Jk_a - M_a AkT per slot.
    for (int a = lane; a < nv; a += 32) {
      const int o = so[a];
      T Ma[B][3];
      coupling_block<B, T>(Jc, Jp, o, Ma);
      const T* jc = Jc + (size_t)o * 2 * B;
      const T* jk = Jk + (size_t)o * 8;
      const size_t ca = (size_t)B * sc[a];
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T x = jc[i] * jk[j] + jc[B + i] * jk[4 + j] -
                      (Ma[i][0] * AkT[0][j] + Ma[i][1] * AkT[1][j] + Ma[i][2] * AkT[2][j]);
          add_entry<T>(acc, er, bad, n, ca + i, kc + j, x);
          add_entry<T>(acc, er, bad, n, kc + j, ca + i, x);
        }
    }
    if (lane < 16) {
      const int i = lane / 4, j = lane % 4;
      const T x = wk[i * 3] * AkT[0][j] + wk[i * 3 + 1] * AkT[1][j] + wk[i * 3 + 2] * AkT[2][j];
      const int ea = er[kc + i], eb = er[kc + j];
      const double v = ldexp(-(double)x, Fix<T>::SHIFT - ea - eb);
      if (ea == SFM_FX_BAD || eb == SFM_FX_BAD) {
      } else if (!(fabs(v) < Fix<T>::LIMIT)) {
        atomicOr(bad, 1);
      } else {
        sfm_fx_add_q<T>(s_kk, 16, lane, sfm_fx_words<T>(v));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 16 * W && s_kk[threadIdx.x] != 0ull) {
    const int w = threadIdx.x / 16, i = threadIdx.x % 16;
    atomicAdd(&acc[w * n * n + (kc + i / 4) * n + kc + i % 4], s_kk[threadIdx.x]);
  }
}

// S = (what the wrapper wrote) + camera blocks U_c + diag(lambda D_c) + the
// coupling sums, rounded to T once; all NaN if a term fell out of bounds.
template <int B, typename T>
__global__ void __launch_bounds__(NT) schur_finish_kernel(
    const unsigned long long* __restrict__ acc, const int* __restrict__ er,
    const int* __restrict__ bad, const T* __restrict__ U,
    const T* __restrict__ lam_diag_c, int C, T* __restrict__ S) {
  const size_t n = (size_t)B * C + 4;
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= n * n) return;
  const size_t r = e / n, s = e % n;
  double v = S[e];
  if (r < (size_t)B * C && r / B == s / B) {
    const size_t c = r / B, i = r % B, j = s % B;
    v += (double)(U[c * B * B + i * B + j] + (i == j ? lam_diag_c[B * c + i] : T(0)));
  }
  const int a = er[r], b = er[s];
  if (*bad || a == SFM_FX_BAD || b == SFM_FX_BAD) {
    v = __longlong_as_double(0x7ff8000000000000ll);
  } else {
    v += sfm_fx_value_t<T>(acc, n * n, e, Fix<T>::SHIFT - a - b);
  }
  S[e] = (T)v;
}

// fx_acc: WORDS x n x n uint64, fx_row: n + 1 int32 (the rows' exponents,
// then the out-of-bounds flag), n = BC + 4.
template <int B, typename T>
int schur_coupling(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                   const void* obs_point, const void* Vinv, const void* perm,
                   const void* perm_valid, const void* U, const void* lam_diag_c, int C, int G,
                   int Vs, void* S, void* fx_acc, void* fx_row, cudaStream_t st) {
  const size_t n = (size_t)B * C + 4;
  int* er = static_cast<int*>(fx_row);
  int* bad = er + n;
  unsigned long long* acc = static_cast<unsigned long long*>(fx_acc);
  cudaError_t e =
      cudaMemsetAsync(acc, 0, SfmFx<T>::WORDS * n * n * sizeof(unsigned long long), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_scale_kernel<B, T><<<(int)((n + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(lam_diag_c), static_cast<const T*>(S), C,
      er);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    const size_t smem = (size_t)2 * WARPS * Vs * sizeof(int);
    e = cudaFuncSetAttribute(schur_coupling_kernel<B, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    schur_coupling_kernel<B, T><<<(G + WARPS - 1) / WARPS, NT, smem, st>>>(
        static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const T*>(Vinv), static_cast<const int*>(perm),
        static_cast<const uint8_t*>(perm_valid), C, G, Vs, er, bad, acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  schur_finish_kernel<B, T><<<(int)((n * n + NT - 1) / NT), NT, 0, st>>>(
      acc, er, bad, static_cast<const T*>(U), static_cast<const T*>(lam_diag_c), C,
      static_cast<T*>(S));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SFM_SCHUR_COUPLING(NAME, B, T)                                                        \
  SFM_API int NAME(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,       \
                   const void* obs_point, const void* Vinv, const void* perm,                 \
                   const void* perm_valid, const void* U, const void* lam_diag_c, int C,      \
                   int G, int Vs, void* S, void* fx_acc, void* fx_row, void* stream) {        \
    return schur_coupling<B, T>(Jc, Jk, Jp, obs_cam, obs_point, Vinv, perm, perm_valid, U,    \
                                lam_diag_c, C, G, Vs, S, fx_acc, fx_row,                      \
                                static_cast<cudaStream_t>(stream));                           \
  }
SFM_SCHUR_COUPLING(sfm_schur_coupling, 6, float)
SFM_SCHUR_COUPLING(sfm_schur_coupling_b10, 10, float)
SFM_SCHUR_COUPLING(sfm_schur_coupling_f64, 6, double)
SFM_SCHUR_COUPLING(sfm_schur_coupling_b10_f64, 10, double)
#undef SFM_SCHUR_COUPLING
