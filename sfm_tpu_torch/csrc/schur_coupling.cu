// Kernel K10: the point coupling of the dense reduced (Schur) system.
//
// Replaces the assembly in sfm_tpu/ba/schur.py::dense_schur_direct (:348-418):
// there the per-slot blocks are scattered onto cameras by one-hot matmuls and
// the camera-pair coupling sum_p sum_{a,b in obs(p)} W_a V_p^-1 W_b^T is one
// (3P' x 6C)^T (3P' x 6C) matmul (an MXU trick), and the camera blocks are one
// scatter (:392). Here the wrapper zeroes S and writes Uk + diag(lambda_k);
// this kernel adds the camera blocks U_c + diag(lambda D_c), subtracts the
// coupling and adds the intrinsics row/column, in place:
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
//
// What bounds it on the H100: atomics into S. The 100-camera, 200k-observation
// scene has ~20k points x ~10 observations: ~1.1M slot pairs x 36 atomics onto
// 360k distinct addresses (~200 each), and ~200 FLOP per pair. Float atomics
// order the sums differently on every run (compare S with a tolerance).
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

__global__ void __launch_bounds__(NT) schur_coupling_kernel(
    const float* __restrict__ Jc, const float* __restrict__ Jk,
    const float* __restrict__ Jp, const int* __restrict__ obs_cam,
    const int* __restrict__ obs_point, const float* __restrict__ Vinv,
    const int* __restrict__ perm, const uint8_t* __restrict__ perm_valid,
    const float* __restrict__ U, const float* __restrict__ lam_diag_c, int C, int G,
    int Vs, float* __restrict__ S) {
  extern __shared__ int sslot[];  // WARPS x Vs observation ids, then WARPS x Vs cams
  __shared__ float s_kk[16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + warp;
  const size_t n = (size_t)6 * C + 4;
  const size_t kc = (size_t)6 * C;
  if (threadIdx.x < 16) s_kk[threadIdx.x] = 0.f;
  // The camera blocks U_c + diag(lambda D_c), spread over the grid; added, as
  // the coupling atomics may land first.
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < (size_t)36 * C;
       e += (size_t)gridDim.x * NT) {
    const size_t c = e / 36, i = e % 36 / 6, j = e % 6;
    const float x = U[e] + (i == j ? lam_diag_c[6 * c + i] : 0.f);
    if (x != 0.f) atomicAdd(&S[(6 * c + i) * n + 6 * c + j], x);
  }
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
          atomicAdd(&S[(ca + i) * n + cb + j], -x);
          if (a != b) atomicAdd(&S[(cb + j) * n + ca + i], -x);
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
          atomicAdd(&S[(ca + i) * n + kc + j], x);
          atomicAdd(&S[(kc + j) * n + ca + i], x);
        }
    }
    if (lane < 16) {
      const int i = lane / 4, j = lane % 4;
      const float x = wk[i * 3] * AkT[0][j] + wk[i * 3 + 1] * AkT[1][j] + wk[i * 3 + 2] * AkT[2][j];
      atomicAdd(&s_kk[lane], -x);
    }
  }
  __syncthreads();
  if (threadIdx.x < 16 && s_kk[threadIdx.x] != 0.f)
    atomicAdd(&S[(kc + threadIdx.x / 4) * n + kc + threadIdx.x % 4], s_kk[threadIdx.x]);
}

}  // namespace

SFM_API int sfm_schur_coupling(const void* Jc, const void* Jk, const void* Jp,
                               const void* obs_cam, const void* obs_point,
                               const void* Vinv, const void* perm, const void* perm_valid,
                               const void* U, const void* lam_diag_c, int C, int G, int Vs,
                               void* S, void* stream) {
  const size_t smem = (size_t)2 * WARPS * Vs * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      schur_coupling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = max((G + WARPS - 1) / WARPS, (36 * C + NT - 1) / NT);
  if (blocks > 0) {
    schur_coupling_kernel<<<blocks, NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Jc), static_cast<const float*>(Jk),
        static_cast<const float*>(Jp), static_cast<const int*>(obs_cam),
        static_cast<const int*>(obs_point), static_cast<const float*>(Vinv),
        static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid),
        static_cast<const float*>(U), static_cast<const float*>(lam_diag_c), C, G, Vs,
        static_cast<float*>(S));
  }
  return static_cast<int>(cudaGetLastError());
}
