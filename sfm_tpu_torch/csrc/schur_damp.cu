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
// sfm_schur_damp, two kernels and no memset:
//  1. the point pass: thread t < P inverts point t's damped block
//     Vd = V + (lambda diag V + 1e-10) I by the 3x3 adjugate after a
//     symmetric Jacobi scaling (D^-1/2 Vd D^-1/2 has a unit diagonal, so the
//     determinant stays in range whatever the point's scale; zero for
//     invalid points) and writes Vinv and h_p = Vinv g_p; thread t < O takes
//     its observation's point's Vinv and h once more, in registers, and the
//     largest |term| of each target (an integer max of the float bits,
//     order-free); thread t < BC + 4 writes the damping diagonals (with the
//     unit pin on dead camera entries);
//  2. the observation walk, 128 consecutive observations a warp (200k
//     observations: ~200 blocks, more than one wave on 132 SMs): per
//     observation y_o = Jp_o h_p, summed as Jc_o^T y_o into its camera's rhs
//     and as Jk_o^T y_o into rhs_k, as order-free fixed-point sums
//     (sfm_common.cuh) at the shifts of max |term| x G Vs (G x Vs: the
//     per-point grouping's slots, schur.py::coobs_pairs). A warp whose
//     lanes hold one camera keeps the run's sums in registers and adds them
//     once; one whose lanes hold several sums each camera's terms by
//     shuffles and adds them once. A block stages its sums in shared memory
//     and flushes only the entries it touched (the nonzero words) with one
//     global atomic each, while the WORDS x (BC + 4) words fit in 227 KB;
//     above that -- more than schur.py::max_cameras(B, T) cameras -- the
//     terms go straight into the global words, with the same 64-bit integer
//     atomics: the same sums, so the same bits. The last eight blocks to
//     arrive (a fenced counter) wait for the rest, then round every sum once,
//     rhs = -g + sum, a slice each, and clear the scratch for the next call.
//  The terms, their maxima and so the shifts are those of the two walks
//  over the grouping this replaces (a row outside the grouping has a zero
//  whitened Jp, and adds nothing), so the rhs has their bits, and the models
//  of every path are the same. An a-priori shift from the damped
//  diagonals (Cauchy-Schwarz: |sum_{o in c} Jc_o[:, r] . y_o| <=
//  sqrt(U_rr) sqrt(P max_p |h_p|^2 tr V_p)) would spare the maxima, but it
//  rounds other terms to the grid, so the sums end a bit apart in the last
//  place of a few hundred thousand entries a reconstruct, and the engine
//  turns such bits into other models (PERF.md, section 6).
// sfm_schur_block_jacobi (the PCG path only, more than
// use_dense_schur_below cameras): the block-Jacobi preconditioner of K11,
// schur.py:197-200, Mc = inv(U + diag(lam_diag_c) + 1e-10 I) one warp a
// camera and Mk = inv(Uk + diag(lam_diag_k) + 1e-10 I) in one more warp, by
// Gauss-Jordan elimination with partial pivoting on [A | I] held by columns,
// lane j column j (2B <= 20 lanes): the pivot's column is one lane's, which
// picks the largest |a| (the lowest row on a tie) and broadcasts it; rows are
// swapped and eliminated in registers, each entry updated as the one-thread
// version did (the reference's and the
// twin's inverse is LU with partial pivoting: the same pivots, another order
// of the updates). A pinned camera (U = 0, unit damping diagonal) gets the
// identity, as in the reference; a block that rounding leaves indefinite
// still gets its inverse, where a Cholesky would stop.
// sfm_schur_back_substitute: dp = Vinv (-g_p) for every point, then eight
// lanes a grouping row (one slot each, its lane 0 adding them in slot order)
// overwrite its point's dp with Vinv (-g_p - sum_o Jp_o^T (Jc_o xc + Jk_o xk));
// no atomics, deterministic, and the sums' order is the row's.
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
// camera atomics dominate at these sizes. The shared-memory limit of the
// staged walk is set once, when the library loads (sfm_schur_damp_setup).
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;              // the walk and the back-substitution
constexpr int WARP_OBS = 128;        // observations a warp of the walk takes, 32 a round
constexpr int TILE = NT / 32 * WARP_OBS;   // observations a block of the walk
constexpr int ROW_LANES = 8;         // lanes of a grouping row (back-substitution)
constexpr int BJ_WARPS = 2;          // warps a block of the block-Jacobi inverses
constexpr int FIN_UNROLL = 8;        // sums a finishing thread rounds at once
constexpr int FINISHERS = 8;         // blocks of the walk that round the sums

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

// Vinv of valid point p (the adjugate of the damped block), zero otherwise,
// and h = Vinv g_p.
template <typename T>
__device__ __forceinline__ void point_solve(const T* __restrict__ V,
                                            const uint8_t* __restrict__ point_valid,
                                            const T* __restrict__ g_p, int p, T lam, T out[9],
                                            T hp[3]) {
  if (point_valid[p]) {
    T Vd[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Vd[k] = V[(size_t)p * 9 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) Vd[k * 4] = Vd[k * 4] + (lam * Vd[k * 4] + eps<T>());
    inv3_scaled<T>(Vd, out);
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = T(0);
  }
  const T* gp = g_p + (size_t)p * 3;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    hp[r] = out[r * 3] * gp[0] + out[r * 3 + 1] * gp[1] + out[r * 3 + 2] * gp[2];
}

// The point pass. Thread t < P: point t's Vinv and h. Thread t < O:
// observation t's point's Vinv and h once more, in registers, and its terms'
// magnitudes, whose largest a target takes (an integer max of the float
// bits, order-free: one max a warp where all its live lanes hold one
// camera), staged in shared memory (SH) or straight into gmax. Thread
// t < BC + 4: the damping diagonals. gmax is zero before the call (the
// walk's finishers clear it).
template <int B, typename T, bool SH>
__global__ void __launch_bounds__(NT) damp_point_kernel(
    const T* __restrict__ V, const uint8_t* __restrict__ point_valid,
    const T* __restrict__ g_p, const T* __restrict__ U, const T* __restrict__ Uk,
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point, int P, int C, int O,
    T lam, T* __restrict__ Vinv, T* __restrict__ h, T* __restrict__ lam_diag_c,
    T* __restrict__ lam_diag_k, unsigned int* __restrict__ gmax) {
  extern __shared__ unsigned long long s_dyn[];
  unsigned int* s_max = reinterpret_cast<unsigned int*>(s_dyn);  // n maxima (SH)
  unsigned long long* mx = SH ? s_dyn : reinterpret_cast<unsigned long long*>(gmax);
  unsigned int* mx32 = reinterpret_cast<unsigned int*>(mx);
  const int n = B * C + 4;
  if (SH) {
    for (int i = threadIdx.x; i < n; i += NT) s_max[i] = 0u;
    __syncthreads();
  }
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t < P) {
    T out[9], hp[3];
    point_solve<T>(V, point_valid, g_p, t, lam, out, hp);
#pragma unroll
    for (int k = 0; k < 9; ++k) Vinv[(size_t)t * 9 + k] = out[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) h[(size_t)t * 3 + r] = hp[r];
  }
  SfmFxPart rk[4];
  int cam = -1;
  T v[B];
  if (t < O) {
    T out[9], hp[3];
    point_solve<T>(V, point_valid, g_p, obs_point[t], lam, out, hp);
    const T* jp = Jp + (size_t)t * 6;
    const T y0 = jp[0] * hp[0] + jp[1] * hp[1] + jp[2] * hp[2];
    const T y1 = jp[3] * hp[0] + jp[4] * hp[1] + jp[5] * hp[2];
    if (y0 != T(0) || y1 != T(0)) {  // else a dead row (its whitened Jp is zero)
      cam = obs_cam[t];
      const T* jc = Jc + (size_t)t * 2 * B;
#pragma unroll
      for (int k = 0; k < B; ++k) v[k] = jc[k] * y0 + jc[B + k] * y1;
      const T* jk = Jk + (size_t)t * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k) sfm_fx_part<T, false>(rk[k], jk[k] * y0 + jk[4 + k] * y1, 0);
    }
  }
  const unsigned live = __ballot_sync(0xffffffffu, cam >= 0);
  if (live != 0u) {
    const int c0 = __shfl_sync(0xffffffffu, cam, __ffs(live) - 1);
    const bool same = __all_sync(0xffffffffu, cam < 0 || cam == c0);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      unsigned int b = cam >= 0 && v[k] != T(0) ? sfm_fx_mag(v[k]) : 0u;
      if (same) {
        b = __reduce_max_sync(0xffffffffu, b);
        if (threadIdx.x % 32 == 0 && b != 0u) atomicMax(mx32 + c0 * B + k, b);
      } else if (b != 0u) {
        atomicMax(mx32 + cam * B + k, b);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<T, false>(mx, n, B * C + k, rk[k]);
  if (SH) {
    __syncthreads();
    sfm_fx_flush<T, false>(s_dyn, n, gmax, nullptr);
  }
  if (t < B * C) {
    const T d = U[(size_t)(t / B) * B * B + (t % B) * (B + 1)];
    lam_diag_c[t] = lam * d + (d <= eps<T>() ? T(1) : T(0));
  }
  if (t < 4) lam_diag_k[t] = lam * Uk[t * 5] + eps<T>();
}

// A warp's run: the lanes' shares of one camera's B sums, added with one
// atomic a word when the run ends (all 32 lanes call it; run is warp-uniform).
template <int B, typename T>
__device__ __forceinline__ void flush_run(unsigned long long* acc, int n, int run,
                                          SfmFxPart (&part)[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    sfm_fx_put_warp<T, true>(acc, n, run * B + k, part[k]);
    part[k] = SfmFxPart();
  }
}

// SH: the block stages its sums in shared memory; otherwise they go to the
// global words directly. A warp walks WARP_OBS consecutive observations, 32
// a round. Where every live lane of a round holds the same camera (the
// observations are grouped by camera), the lanes keep their terms in
// registers across rounds and the warp adds the run's sums once, at the
// shifts of that camera; otherwise (grouped by point: a round holds ~3
// points' views) the lanes of each camera sum their terms by shuffles and
// one lane adds them. Integer sums either way: the same bits.
template <int B, typename T, bool SH>
__global__ void __launch_bounds__(NT) damp_rhs_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point, int O, int C,
    double count, const T* __restrict__ h, const T* __restrict__ g_c,
    const T* __restrict__ g_k, unsigned int* __restrict__ gmax, unsigned int* __restrict__ ctrl,
    unsigned long long* __restrict__ gacc, T* __restrict__ rhs_c, T* __restrict__ rhs_k) {
  extern __shared__ unsigned long long s_stage[];  // C x B camera sums, then 4 intrinsics sums
  unsigned long long* acc = SH ? s_stage : gacc;
  const int n = B * C + 4;
  if (SH) sfm_fx_stage_zero<T>(s_stage, n);
  int shk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) shk[k] = sfm_fx_max_shift<T>(gmax, B * C + k, count);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int o0 = blockIdx.x * TILE + (threadIdx.x / 32) * WARP_OBS;
  SfmFxPart rk[4], part[B];
  int run = -1, run_sh[B];
  for (int r = 0; r < WARP_OBS; r += 32) {
    const int o = o0 + r + lane;
    int cam = -1;
    T v[B];
    if (o < O) {
      const T* hp = h + (size_t)obs_point[o] * 3;
      const T* jp = Jp + (size_t)o * 6;
      const T y0 = jp[0] * hp[0] + jp[1] * hp[1] + jp[2] * hp[2];
      const T y1 = jp[3] * hp[0] + jp[4] * hp[1] + jp[5] * hp[2];
      if (y0 != T(0) || y1 != T(0)) {  // else a dead row (its whitened Jp is zero)
        cam = obs_cam[o];
        const T* jc = Jc + (size_t)o * 2 * B;
#pragma unroll
        for (int k = 0; k < B; ++k) v[k] = jc[k] * y0 + jc[B + k] * y1;
        const T* jk = Jk + (size_t)o * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sfm_fx_part<T, true>(rk[k], jk[k] * y0 + jk[4 + k] * y1, shk[k]);
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, cam >= 0);
    if (live == 0u) continue;
    const int c0 = __shfl_sync(0xffffffffu, cam, __ffs(live) - 1);
    const bool same = __all_sync(0xffffffffu, cam < 0 || cam == c0);
    if (!same || c0 != run) {
      if (run >= 0) flush_run<B, T>(acc, n, run, part);
      run = same ? c0 : -1;
      if (same)
#pragma unroll
        for (int k = 0; k < B; ++k) run_sh[k] = sfm_fx_max_shift<T>(gmax, c0 * B + k, count);
    }
    if (same) {
      if (cam >= 0)
#pragma unroll
        for (int k = 0; k < B; ++k) sfm_fx_part<T, true>(part[k], v[k], run_sh[k]);
      continue;
    }
    // The lanes that hold one camera add their terms as one: a tree over
    // their ranks (lane of rank + 2^l by __fns), then the group's first lane
    // adds the sum.
    const unsigned peers = __match_any_sync(0xffffffffu, cam);
    const int rank = __popc(peers & ((1u << lane) - 1u)), cnt = __popc(peers);
    int src[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const unsigned f = __fns(peers, lane, (1 << l) + 1);
      src[l] = f < 32u ? (int)f : lane;
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      SfmFxQ q = {0, 0};
      if (cam >= 0 && v[k] != T(0)) {
        const int sh = sfm_fx_max_shift<T>(gmax, cam * B + k, count);
        if (sh != SFM_FX_BAD) q = sfm_fx_q(v[k], sh);
      }
#pragma unroll
      for (int l = 0; l < 5; ++l) {
        const long long hi = __shfl_sync(0xffffffffu, q.hi, src[l]);
        const long long lo =
            SfmFx<T>::WORDS == 2 ? __shfl_sync(0xffffffffu, q.lo, src[l]) : 0ll;
        if ((rank & ((2 << l) - 1)) == 0 && rank + (1 << l) < cnt) {
          q.hi += hi;
          q.lo += lo;
        }
      }
      if (rank == 0 && cam >= 0) sfm_fx_add_q<T>(acc, n, cam * B + k, q);
    }
  }
  if (run >= 0) flush_run<B, T>(acc, n, run, part);
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<T, true>(acc, n, B * C + k, rk[k]);
  if (SH) {
    __syncthreads();
    sfm_fx_flush<T, true>(s_stage, n, nullptr, gacc);
  }
  // The last FINISHERS blocks to arrive (a fenced counter) wait for the
  // others, then round every sum once, a slice each, and clear the scratch.
  // They are the last tickets, so every other block has started and runs to
  // its end: the wait cannot hold one up.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_stage[0] = atomicAdd(ctrl, 1u);  // the stage is flushed
  __syncthreads();
  const unsigned ticket = static_cast<unsigned>(s_stage[0]);
  const unsigned nfin = min((unsigned)FINISHERS, gridDim.x), first_fin = gridDim.x - nfin;
  if (ticket < first_fin) return;
  if (threadIdx.x == 0)
    while (atomicAdd(ctrl, 0u) < gridDim.x) __nanosleep(64);
  __syncthreads();
  __threadfence();
  // FIN_UNROLL entries a thread at a time, their loads issued together and read
  // from L2 (__ldcg: the other blocks' atomics are there, not in this L1).
  const int stride = nfin * NT;
  for (int i0 = (ticket - first_fin) * NT + threadIdx.x; i0 < n; i0 += stride * FIN_UNROLL) {
    unsigned long long hi[FIN_UNROLL], lo[FIN_UNROLL];
    int sh[FIN_UNROLL];
    double g[FIN_UNROLL];
#pragma unroll
    for (int u = 0; u < FIN_UNROLL; ++u) {
      const int i = i0 + u * stride;
      if (i < n) {
        hi[u] = __ldcg(gacc + i);
        lo[u] = SfmFx<T>::WORDS == 2 ? __ldcg(gacc + n + i) : 0ull;
        sh[u] = sfm_fx_max_shift<T>(gmax, i, count);
        g[u] = i < B * C ? (double)g_c[i] : (double)g_k[i - B * C];
      }
    }
#pragma unroll
    for (int u = 0; u < FIN_UNROLL; ++u) {
      const int i = i0 + u * stride;
      if (i >= n) break;
      const double s = SfmFx<T>::WORDS == 1 ? sfm_fx_value(hi[u], sh[u])
                                              : sfm_fx_value2(hi[u], lo[u], sh[u]);
      if (i < B * C)
        rhs_c[i] = (T)(-g[u] + s);
      else
        rhs_k[i - B * C] = (T)(-g[u] + s);
      gacc[i] = 0ull;
      if (SfmFx<T>::WORDS == 2) gacc[n + i] = 0ull;
      gmax[i] = 0u;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctrl + 1, 1u) == nfin - 1) {  // the last finisher out
      ctrl[0] = 0u;
      ctrl[1] = 0u;
    }
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
  const int t = blockIdx.x * NT + threadIdx.x;
  const int g = t / ROW_LANES, lane = t % ROW_LANES;
  const int first = threadIdx.x % 32 - lane;  // the row's lane 0 in the warp
  const bool row = g < G && perm_valid[(size_t)g * Vs];
  T k4[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) k4[k] = xk[k];
  T u[3] = {T(0), T(0), T(0)};
  // Each lane takes one slot of a chunk of ROW_LANES; the row's lane 0 adds
  // the slots' terms in slot order, as one thread walking the row would.
  for (int s0 = 0; s0 < Vs; s0 += ROW_LANES) {
    const int s = s0 + lane;
    const bool live = row && s < Vs && perm_valid[(size_t)g * Vs + s];
    if (!__any_sync(0xffffffffu, live)) break;
    T c[3] = {T(0), T(0), T(0)};
    if (live) {
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
      for (int i = 0; i < 3; ++i) c[i] = jp[i] * a[0] + jp[3 + i] * a[1];
    }
#pragma unroll
    for (int l = 0; l < ROW_LANES; ++l)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T ci = __shfl_sync(0xffffffffu, c[i], first + l);
        if (lane == 0) u[i] += ci;   // an empty slot adds +0: no change
      }
  }
  if (row && lane == 0) {
    const int p = obs_point[perm[(size_t)g * Vs]];
    point_step<T>(Vinv + (size_t)p * 9, g_p + (size_t)p * 3, u, dp + (size_t)p * 3);
  }
}

// inv(Bk + diag(lam_diag) + 1e-10 I) by one warp: lane j < N holds column j of
// the matrix, lane N + j column j of I, as registers a[0..N). Gauss-Jordan
// with partial pivoting: the pivot column's lane picks the largest |a| at or
// below the diagonal (the lowest row on a tie) and broadcasts its row; every
// lane swaps the two rows, scales the pivot row and eliminates the others,
// a[i][j] -= a[i][col] a[col][j], the updates of the one-thread version.
template <int N, typename T>
__device__ __forceinline__ void warp_block_inverse(const T* __restrict__ Bk,
                                                   const T* __restrict__ lam_diag,
                                                   T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  T a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (lane < N)
      a[i] = i == lane ? (Bk[i * N + lane] + lam_diag[i]) + eps<T>() : Bk[i * N + lane];
    else
      a[i] = lane - N == i ? T(1) : T(0);
  }
#pragma unroll
  for (int col = 0; col < N; ++col) {
    int piv = col;
    if (lane == col) {
      T best = t_abs(a[col]);
#pragma unroll
      for (int i = col + 1; i < N; ++i)
        if (t_abs(a[i]) > best) {
          best = t_abs(a[i]);
          piv = i;
        }
    }
    piv = __shfl_sync(0xffffffffu, piv, col);
    if (piv != col) {
      const T t = a[col];
#pragma unroll
      for (int i = col + 1; i < N; ++i)
        if (i == piv) {
          a[col] = a[i];
          a[i] = t;
        }
    }
    const T d = T(1) / __shfl_sync(0xffffffffu, a[col], col);
    a[col] *= d;
    T f[N];
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __shfl_sync(0xffffffffu, a[i], col);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i != col) a[i] -= f[i] * a[col];
  }
  if (lane >= N && lane < 2 * N)
#pragma unroll
    for (int i = 0; i < N; ++i) out[i * N + lane - N] = a[i];
}

template <int B, typename T>
__global__ void __launch_bounds__(32 * BJ_WARPS) block_jacobi_kernel(
    const T* __restrict__ U, const T* __restrict__ lam_diag_c,
    const T* __restrict__ Uk, const T* __restrict__ lam_diag_k, int C,
    T* __restrict__ Mc, T* __restrict__ Mk) {
  const int w = blockIdx.x * BJ_WARPS + threadIdx.x / 32;  // one warp a block
  if (w < C)
    warp_block_inverse<B, T>(U + (size_t)w * B * B, lam_diag_c + (size_t)w * B,
                             Mc + (size_t)w * B * B);
  else if (w == C)
    warp_block_inverse<4, T>(Uk, lam_diag_k, Mk);
}

template <int B, typename T>
int schur_block_jacobi(const void* U, const void* lam_diag_c, const void* Uk,
                       const void* lam_diag_k, int C, void* Mc, void* Mk, cudaStream_t st) {
  block_jacobi_kernel<B, T><<<C / BJ_WARPS + 1, 32 * BJ_WARPS, 0, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(lam_diag_c), static_cast<const T*>(Uk),
      static_cast<const T*>(lam_diag_k), C, static_cast<T*>(Mc), static_cast<T*>(Mk));
  return static_cast<int>(cudaGetLastError());
}

// h: P x 3 (T); gmax: n = BC + 4 uint32, ctrl: 2 uint32 and fx_acc: WORDS x n
// uint64, all three zero before the first call (the walk's finishers clear
// them).
template <int B, typename T>
int schur_damp(const void* V, const void* point_valid, const void* U, const void* Uk,
               const void* g_c, const void* g_k, const void* g_p, const void* Jc,
               const void* Jk, const void* Jp, const void* obs_cam, const void* obs_point,
               int P, int C, int G, int Vs, int O, int in_shared, T lam, void* Vinv,
               void* lam_diag_c, void* lam_diag_k,
               void* rhs_c, void* rhs_k, void* h, void* gmax, void* ctrl, void* fx_acc,
               cudaStream_t st) {
  const int n = B * C + 4;
  const int n1 = max(max(P, O), n);
  unsigned int* gm = static_cast<unsigned int*>(gmax);
  unsigned int* ct = static_cast<unsigned int*>(ctrl);
  unsigned long long* gacc = static_cast<unsigned long long*>(fx_acc);
#define DAMP_POINT_ARGS                                                                      \
  static_cast<const T*>(V), static_cast<const uint8_t*>(point_valid),                        \
      static_cast<const T*>(g_p), static_cast<const T*>(U), static_cast<const T*>(Uk),       \
      static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),       \
      static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point), P, C, O, lam,    \
      static_cast<T*>(Vinv), static_cast<T*>(h), static_cast<T*>(lam_diag_c),                \
      static_cast<T*>(lam_diag_k), gm
  const int pblocks = (n1 + NT - 1) / NT;
  if (in_shared)
    damp_point_kernel<B, T, true><<<pblocks, NT, (size_t)n * 4, st>>>(DAMP_POINT_ARGS);
  else
    damp_point_kernel<B, T, false><<<pblocks, NT, 0, st>>>(DAMP_POINT_ARGS);
#undef DAMP_POINT_ARGS
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = max(1, (O + TILE - 1) / TILE);
  const double count = G > 0 ? (double)G * Vs : 1.0;
#define DAMP_RHS_ARGS                                                                        \
  static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),           \
      static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point), O, C, count,     \
      static_cast<const T*>(h), static_cast<const T*>(g_c), static_cast<const T*>(g_k), gm,  \
      ct, gacc, static_cast<T*>(rhs_c), static_cast<T*>(rhs_k)
  // Dynamic shared memory: the stage (SH), and a finisher's ticket after it.
  if (in_shared)
    damp_rhs_kernel<B, T, true><<<blocks, NT, (size_t)SfmFx<T>::WORDS * n * 8, st>>>(
        DAMP_RHS_ARGS);
  else
    damp_rhs_kernel<B, T, false><<<blocks, NT, 8, st>>>(DAMP_RHS_ARGS);
#undef DAMP_RHS_ARGS
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
    back_row_kernel<B, T><<<((size_t)G * ROW_LANES + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), G, Vs,
        static_cast<const T*>(Vinv), static_cast<const T*>(g_p), static_cast<const T*>(xc),
        static_cast<const T*>(xk), static_cast<T*>(dp));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
cudaError_t allow_dynamic_shared(K kernel, int bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes - (int)attr.sharedSizeBytes);
}

template <int B, typename T>
cudaError_t allow_staged_walk(int bytes) {
  cudaError_t e = allow_dynamic_shared(damp_rhs_kernel<B, T, true>, bytes);
  return e == cudaSuccess ? allow_dynamic_shared(damp_point_kernel<B, T, true>, bytes) : e;
}

}  // namespace

// Once, when the library loads: the staged walk of every route may take the
// device's opt-in shared memory (227 KB on the H100; schur.py::_SMEM_BYTES).
SFM_API int sfm_schur_damp_setup(void* /*stream*/) {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_staged_walk<6, float>(bytes);
  if (e == cudaSuccess) e = allow_staged_walk<10, float>(bytes);
  if (e == cudaSuccess) e = allow_staged_walk<6, double>(bytes);
  if (e == cudaSuccess) e = allow_staged_walk<10, double>(bytes);
  return static_cast<int>(e);
}

// The default route (B = 6, float; lam a float) and the others (lam a double,
// exact for the LM loop's float32 lambda).
#define SFM_SCHUR_DAMP(NAME, B, T, LAM)                                                       \
  SFM_API int NAME(const void* V, const void* point_valid, const void* U, const void* Uk,     \
                   const void* g_c, const void* g_k, const void* g_p, const void* Jc,         \
                   const void* Jk, const void* Jp, const void* obs_cam, const void* obs_point, \
                   int P, int C, int G, int Vs, int O, int in_shared, LAM lam, void* Vinv,    \
                   void* lam_diag_c,                                                          \
                   void* lam_diag_k, void* rhs_c, void* rhs_k, void* h, void* gmax,           \
                   void* ctrl, void* fx_acc, void* stream) {                                  \
    return schur_damp<B, T>(V, point_valid, U, Uk, g_c, g_k, g_p, Jc, Jk, Jp, obs_cam,        \
                            obs_point, P, C, G, Vs, O, in_shared, (T)lam, Vinv, lam_diag_c,   \
                            lam_diag_k, rhs_c, rhs_k, h, gmax, ctrl, fx_acc,                  \
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
