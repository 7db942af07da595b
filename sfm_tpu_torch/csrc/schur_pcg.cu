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
// sfm_schur_matvec, three kernels and no memset, over a layout built once a
// BA problem (ba/schur.py::matvec_layout: `walk`, the grouping's
// observations point by point in slot order; `row_start`, each point's run
// in it; `cam_walk`, the slots in camera-major order; `cam_of`, the camera
// of each camera-major place):
//  1. the point pass, eight points a warp (a lane owns a point; the warp
//     reads the points' observations 32 at a time, one a lane, 16 bytes a
//     load): for each observation a_o = Jc_o x_c(o) + Jk_o xk and
//     Jp_o^T a_o, which the owner adds in slot order into u; v = Vinv_p u;
//     then, per observation again (from cache), d_o = a_o - Jp_o v and its
//     B + 4 terms Jc_o^T d_o, Jk_o^T d_o, written at its slot: coalesced
//     stores (scattered to the camera-major places instead, they doubled
//     the pass's time on the card; PERF.md, section 6);
//  2. the max walk over the camera-major places (each reads its slot's
//     terms): each target's largest |term| (an integer max of the float
//     bits), a warp's run of one camera kept in registers and combined with
//     one atomic a word;
//  3. the add walk, the same, at the shifts those maxima give, as
//     order-free fixed-point sums (sfm_common.cuh). Its last eight blocks to
//     arrive (a fenced counter) wait for the rest, round every sum once,
//     Sx = lam_diag o x (+ U_extra_c x_c, + Hreg_k xk) + the sum, a slice
//     each, and clear the scratch for the next call.
// Each term is computed by the same float operations as the two walks over
// the grouping that this replaces (apply_b, u in slot order, Vinv u, d, the
// products, in the same expressions), each target's maximum and so its
// shift (max x G_pad Vs) are theirs, the integer sums are order-free, and the
// finish rounds as theirs did: Sx has their bits, and every model stays.
// The camera sums go to global memory from each run's end whatever C is:
// a walk of camera-major terms touches a few words a warp, so no shared
// staging copy and no camera cap.
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
// products cannot rebuild).
//
// What bounds it on the H100: memory. A matvec must read each valid
// observation's whitened Jacobians (13 x 2 floats), its camera and point ids
// and its slot (~116 bytes) and each point's Vinv (36 bytes): at 560k
// observations ~65 MB, ~20 us at 3.35 TB/s; ~150 FLOP an observation is
// ~1.3 us of f32. The point pass reads that once from device memory (its
// second look at an observation comes from cache) and writes the terms (40
// bytes an observation at B = 6, 22 MB), which the two walks read back.
// The CG step moves a few (6C + 4)-vectors and the 36C floats of Mc:
// nothing; one block and its launch are its cost.
#include <type_traits>

#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;        // matvec threads a block
constexpr int NB = 1024;       // the one block of the CG kernels
constexpr int RPW = 8;         // grouping rows a warp of the point pass, one a lane
constexpr int WALK_POS = 256;  // camera-major places a warp of the walks at most, 32 a round
constexpr int FINISHERS = 8;   // blocks of the add walk that finish S x

template <typename T>
__device__ __forceinline__ T eps() {
  return T(1e-10);
}
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }

// Sx[i] = lam_diag o x (+ U_extra_c x_c on the cameras, + Hreg_k xk on the
// intrinsics) + s, s the coupling sum of entry i.
template <int B, typename T>
__device__ __forceinline__ void finish_entry(const T* __restrict__ lam_diag_c,
                                             const T* __restrict__ lam_diag_k,
                                             const T* __restrict__ Hreg_k,
                                             const T* __restrict__ U_extra,
                                             const T* __restrict__ x, int C, int i, double s,
                                             T* __restrict__ Sx) {
  const int nB = B * C;
  if (i < nB) {
    T d = lam_diag_c[i] * x[i];
    if (U_extra != nullptr) {
      const int c = i / B, r = i % B;
      T u = T(0);
#pragma unroll
      for (int j = 0; j < B; ++j) u += U_extra[(size_t)c * B * B + r * B + j] * x[c * B + j];
      d += u;
    }
    Sx[i] = (T)((double)d + s);
  } else {
    const int k = i - nB;
    T h = T(0);
#pragma unroll
    for (int j = 0; j < 4; ++j) h += Hreg_k[k * 4 + j] * x[nB + j];
    Sx[i] = (T)((double)(lam_diag_k[k] * x[i] + h) + s);
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

// N values from p into registers, 16 bytes a load where a row of N values
// keeps 16-byte alignment, else two values a load (rows start at multiples
// of N values; the wrapper checks the tensors' alignment).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&r)[N]) {
  if constexpr (sizeof(T) == 4 && (N * sizeof(T)) % 16 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = q[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "rows of an even length");
    using P = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
    const P* q = reinterpret_cast<const P*>(p);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const P v = q[i];
      r[2 * i] = v.x;
      r[2 * i + 1] = v.y;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ p, const T (&r)[N]) {
  static_assert(N % 2 == 0, "rows of an even length");
  using P = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
  P* q = reinterpret_cast<P*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) q[i] = P{r[2 * i], r[2 * i + 1]};
}

// The point pass (see the header). Lane l < RPW owns grouping row
// r0 + l; the warp walks the rows' observations 32 at a time, a lane an
// observation, and writes each one's terms at its slot (coalesced).
template <int B, typename T>
__global__ void __launch_bounds__(NT) matvec_point_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const int* __restrict__ walk, const int* __restrict__ row_start, int R, int C,
    const T* __restrict__ Vinv, const T* __restrict__ x, const T* __restrict__ flag,
    T* __restrict__ terms) {
  if (flag != nullptr && *flag == T(0)) return;  // the same for the whole block
  constexpr int TW = B + 4;
  __shared__ T s_pt[NT / 32][32][3];   // a round's Jp_o^T a_o
  __shared__ T s_v[NT / 32][RPW][3];   // the warp's points' v
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int r0 = (blockIdx.x * (NT / 32) + w) * RPW;
  if (r0 >= R) return;  // the whole warp
  const int nr = min(RPW, R - r0), nB = B * C;
  int rs = 0, re = 0;
  if (lane < nr) {
    rs = row_start[r0 + lane];
    re = row_start[r0 + lane + 1];
  }
  const int s0 = __shfl_sync(0xffffffffu, rs, 0), s1 = __shfl_sync(0xffffffffu, re, nr - 1);
  T xk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) xk[k] = x[nB + k];
  // u = sum_o Jp_o^T a_o, in slot order.
  T u[3] = {T(0), T(0), T(0)};
  for (int base = s0; base < s1; base += 32) {
    const int j = base + lane;
    if (j < s1) {
      const int o = walk[j];
      T jc[2 * B], jk[8], jp[6], xc[B], a[2];
      load_row(Jc + (size_t)o * 2 * B, jc);
      load_row(Jk + (size_t)o * 8, jk);
      load_row(Jp + (size_t)o * 6, jp);
      load_row(x + (size_t)obs_cam[o] * B, xc);
      apply_b<B, T>(jc, jk, xc, xk, a);
#pragma unroll
      for (int i = 0; i < 3; ++i) s_pt[w][lane][i] = jp[i] * a[0] + jp[3 + i] * a[1];
    }
    __syncwarp();
    if (lane < nr) {
      const int hi = min(re, base + 32);
      for (int jj = max(rs, base); jj < hi; ++jj) {
#pragma unroll
        for (int i = 0; i < 3; ++i) u[i] += s_pt[w][jj - base][i];
      }
    }
    __syncwarp();
  }
  if (lane < nr) {
    const T* Vi = Vinv + (size_t)obs_point[walk[rs]] * 9;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s_v[w][lane][i] = Vi[i * 3] * u[0] + Vi[i * 3 + 1] * u[1] + Vi[i * 3 + 2] * u[2];
  }
  __syncwarp();
  // d_o = a_o - Jp_o v and the observation's terms.
  for (int base = s0; base < s1; base += 32) {
    const int j = base + lane;
    int row = -1;  // the last of the warp's rows that starts at or before j
#pragma unroll
    for (int l = 0; l < RPW; ++l) {
      const int rl = __shfl_sync(0xffffffffu, rs, l);
      row += (l < nr && rl <= j) ? 1 : 0;
    }
    if (j < s1) {
      const int o = walk[j];
      T jc[2 * B], jk[8], jp[6], xc[B], a[2], t[TW];
      load_row(Jc + (size_t)o * 2 * B, jc);
      load_row(Jk + (size_t)o * 8, jk);
      load_row(Jp + (size_t)o * 6, jp);
      load_row(x + (size_t)obs_cam[o] * B, xc);
      const T* v = s_v[w][row];
      apply_b<B, T>(jc, jk, xc, xk, a);
      const T d0 = a[0] - (jp[0] * v[0] + jp[1] * v[1] + jp[2] * v[2]);
      const T d1 = a[1] - (jp[3] * v[0] + jp[4] * v[1] + jp[5] * v[2]);
#pragma unroll
      for (int k = 0; k < B; ++k) t[k] = jc[k] * d0 + jc[B + k] * d1;
#pragma unroll
      for (int k = 0; k < 4; ++k) t[B + k] = jk[k] * d0 + jk[4 + k] * d1;
      store_row(terms + (size_t)j * TW, t);
    }
  }
}

// A warp's run of one camera: the lanes' parts of its B targets, combined
// and added with one atomic a word (all 32 lanes call it; run is uniform).
template <int B, typename T, bool ADD>
__device__ __forceinline__ void flush_run(unsigned long long* dst, int n, int run,
                                          SfmFxPart (&part)[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    sfm_fx_put_warp<T, ADD>(dst, n, run * B + k, part[k]);
    part[k] = SfmFxPart();
  }
}

// The max walk (ADD false) and the add walk (ADD true) over the terms in
// camera-major order, walk_pos places a warp, 32 a round. The lanes of a
// camera keep their parts in registers across rounds; the warp adds a run's
// parts when its camera changes. The intrinsics' parts are combined over the
// block in shared memory and added with one atomic a word. The add walk's
// last FINISHERS blocks then finish S x (see the header). gmax, gacc and ctrl
// are zero before the max walk (the add walk's finishers clear them).
template <int B, typename T, bool ADD>
__global__ void __launch_bounds__(NT) matvec_walk_kernel(
    const T* __restrict__ terms, const int* __restrict__ cam_walk,
    const int* __restrict__ cam_of, int Ov, int C, double count,
    const T* __restrict__ flag, unsigned int* __restrict__ gmax,
    unsigned long long* __restrict__ gacc, unsigned int* __restrict__ ctrl,
    const T* __restrict__ lam_diag_c, const T* __restrict__ lam_diag_k,
    const T* __restrict__ Hreg_k, const T* __restrict__ U_extra, const T* __restrict__ x,
    T* __restrict__ Sx, int walk_pos) {
  if (flag != nullptr && *flag == T(0)) return;  // the same for the whole block
  constexpr int TW = B + 4, WORDS = SfmFx<T>::WORDS;
  __shared__ unsigned long long s_k[2 * 4];  // the block's intrinsics parts
  __shared__ unsigned int s_ticket;
  const int n = B * C + 4, nB = B * C;
  unsigned long long* dst = ADD ? gacc : reinterpret_cast<unsigned long long*>(gmax);
  if (threadIdx.x < 2 * 4) s_k[threadIdx.x] = 0ull;
  int shk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) shk[k] = ADD ? sfm_fx_max_shift<T>(gmax, nB + k, count) : 0;
  const int lane = threadIdx.x % 32;
  const int p0 = (blockIdx.x * (NT / 32) + threadIdx.x / 32) * walk_pos;
  SfmFxPart part[B], rk[4];
  int run = -1, run_sh[B];
  for (int r = 0; r < walk_pos; r += 32) {
    const int p = p0 + r + lane;
    int cam = -1;
    T v[TW];
    if (p < Ov) {
      cam = cam_of[p];
      load_row(terms + (size_t)cam_walk[p] * TW, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) sfm_fx_part<T, ADD>(rk[k], v[B + k], shk[k]);
    }
    unsigned pending = __ballot_sync(0xffffffffu, cam >= 0);
    while (pending != 0u) {  // the round's cameras in turn (one, where a run goes on)
      const int c = __shfl_sync(0xffffffffu, cam, __ffs(pending) - 1);
      if (c != run) {
        if (run >= 0) flush_run<B, T, ADD>(dst, n, run, part);
        run = c;
        if (ADD)
#pragma unroll
          for (int k = 0; k < B; ++k) run_sh[k] = sfm_fx_max_shift<T>(gmax, c * B + k, count);
      }
      if (cam == c)
#pragma unroll
        for (int k = 0; k < B; ++k)
          if (v[k] != T(0)) sfm_fx_part<T, ADD>(part[k], v[k], ADD ? run_sh[k] : 0);
      pending &= ~__ballot_sync(0xffffffffu, cam == c);
    }
  }
  if (run >= 0) flush_run<B, T, ADD>(dst, n, run, part);
  __syncthreads();  // s_k zeroed
#pragma unroll
  for (int k = 0; k < 4; ++k) sfm_fx_put_warp<T, ADD>(s_k, 4, k, rk[k]);
  __syncthreads();
  if (ADD) {
    if (threadIdx.x < WORDS * 4) {
      const int k = threadIdx.x % 4, word = threadIdx.x / 4;
      if (s_k[threadIdx.x] != 0ull) atomicAdd(&gacc[(size_t)word * n + nB + k], s_k[threadIdx.x]);
    }
  } else if (threadIdx.x < 4) {
    const unsigned int b = reinterpret_cast<const unsigned int*>(s_k)[threadIdx.x];
    if (b != 0u) atomicMax(&gmax[nB + threadIdx.x], b);
  }
  if (!ADD) return;
  // The last FINISHERS blocks to arrive (a fenced counter) wait for the
  // others, then finish S x, a slice each, and clear the scratch. They hold
  // the last tickets, so every other block has started and runs to its end:
  // the wait cannot hold one up.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_ticket = atomicAdd(ctrl, 1u);
  __syncthreads();
  const unsigned ticket = s_ticket;
  const unsigned nfin = min((unsigned)FINISHERS, gridDim.x), first_fin = gridDim.x - nfin;
  if (ticket < first_fin) return;
  if (threadIdx.x == 0)
    while (atomicAdd(ctrl, 0u) < gridDim.x) __nanosleep(64);
  __syncthreads();
  __threadfence();
  // Read from L2 (__ldcg): the other blocks' atomics are there, not in this L1.
  for (int i = (ticket - first_fin) * NT + threadIdx.x; i < n; i += nfin * NT) {
    const int sh = sfm_fx_shift_t<T>((double)__uint_as_float(__ldcg(gmax + i)) * count);
    const unsigned long long hi = __ldcg(gacc + i);
    const double s = WORDS == 1 ? sfm_fx_value(hi, sh) : sfm_fx_value2(hi, __ldcg(gacc + n + i), sh);
    finish_entry<B, T>(lam_diag_c, lam_diag_k, Hreg_k, U_extra, x, C, i, s, Sx);
    gacc[i] = 0ull;
    if (WORDS == 2) gacc[n + i] = 0ull;
    gmax[i] = 0u;
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

// Places a warp of the walks takes: WALK_POS, or fewer (down to 64) where
// that would leave fewer than two blocks an SM. The walks are bound by the
// latency of their gathers, so a small problem (the engine's early BA
// calls) runs faster on more, shorter warps, a large one on fewer, longer
// ones (their runs of one camera stay longer); any walk gives the same sums.
int walk_places(int Ov) {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  int wp = WALK_POS;
  while (wp > 64 && (Ov + NT / 32 * wp - 1) / (NT / 32 * wp) < 2 * sms) wp /= 2;
  return wp;
}

// The layout (walk, row_start, cam_walk, cam_of: R rows, Ov slots) and the
// scratch: terms (B + 4) x Ov T; gmax n int32, ctrl 2 int32, acc WORDS x n
// int64, all zero between calls; n = BC + 4. G x Vs: the grouping's slots.
template <int B, typename T>
int schur_matvec(const void* Jc, const void* Jk, const void* Jp, const void* obs_cam,
                 const void* obs_point, const void* Vinv, const void* lam_diag_c,
                 const void* lam_diag_k, const void* Hreg_k, const void* x, const void* walk,
                 const void* row_start, const void* cam_walk, const void* cam_of, int C, int G,
                 int Vs, int R, int Ov, const void* flag, void* Sx, void* terms, void* gmax,
                 void* ctrl, void* acc, const void* U_extra, cudaStream_t st) {
  const T* fl = static_cast<const T*>(flag);
  const double count = G > 0 ? (double)G * Vs : 1.0;
  if (R > 0) {
    const int warps = (R + RPW - 1) / RPW;
    matvec_point_kernel<B, T><<<(warps + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
        static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const int*>(walk), static_cast<const int*>(row_start), R, C,
        static_cast<const T*>(Vinv), static_cast<const T*>(x), fl, static_cast<T*>(terms));
  }
  const int walk_pos = walk_places(Ov);
  const int blocks = max(1, (Ov + NT / 32 * walk_pos - 1) / (NT / 32 * walk_pos));
#define MATVEC_WALK_ARGS                                                                     \
  static_cast<const T*>(terms), static_cast<const int*>(cam_walk),                           \
      static_cast<const int*>(cam_of), Ov, C, count, fl,                                     \
      static_cast<unsigned int*>(gmax), static_cast<unsigned long long*>(acc),               \
      static_cast<unsigned int*>(ctrl), static_cast<const T*>(lam_diag_c),                   \
      static_cast<const T*>(lam_diag_k), static_cast<const T*>(Hreg_k),                      \
      static_cast<const T*>(U_extra), static_cast<const T*>(x), static_cast<T*>(Sx), walk_pos
  if (Ov > 0) matvec_walk_kernel<B, T, false><<<blocks, NT, 0, st>>>(MATVEC_WALK_ARGS);
  matvec_walk_kernel<B, T, true><<<blocks, NT, 0, st>>>(MATVEC_WALK_ARGS);
#undef MATVEC_WALK_ARGS
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

#define SFM_SCHUR_MATVEC_ARGS                                                                 \
  const void *Jc, const void *Jk, const void *Jp, const void *obs_cam, const void *obs_point, \
      const void *Vinv, const void *lam_diag_c, const void *lam_diag_k, const void *Hreg_k,   \
      const void *x, const void *walk, const void *row_start, const void *cam_walk,           \
      const void *cam_of, int C, int G, int Vs, int R, int Ov, const void *flag, void *Sx,    \
      void *terms, void *gmax, void *ctrl, void *acc
#define SFM_SCHUR_MATVEC_CALL(B, T, U_EXTRA)                                                  \
  schur_matvec<B, T>(Jc, Jk, Jp, obs_cam, obs_point, Vinv, lam_diag_c, lam_diag_k, Hreg_k, x, \
                     walk, row_start, cam_walk, cam_of, C, G, Vs, R, Ov, flag, Sx, terms, gmax, \
                     ctrl, acc, U_EXTRA, static_cast<cudaStream_t>(stream))

SFM_API int sfm_schur_matvec(SFM_SCHUR_MATVEC_ARGS, void* stream) {
  return SFM_SCHUR_MATVEC_CALL(6, float, nullptr);
}

// The other routes: U_extra (C, B, B) or null.
#define SFM_SCHUR_MATVEC(NAME, B, T)                                                          \
  SFM_API int NAME(SFM_SCHUR_MATVEC_ARGS, const void* U_extra, void* stream) {                \
    return SFM_SCHUR_MATVEC_CALL(B, T, U_extra);                                              \
  }
SFM_SCHUR_MATVEC(sfm_schur_matvec_b10, 10, float)
SFM_SCHUR_MATVEC(sfm_schur_matvec_f64, 6, double)
SFM_SCHUR_MATVEC(sfm_schur_matvec_b10_f64, 10, double)
#undef SFM_SCHUR_MATVEC
#undef SFM_SCHUR_MATVEC_CALL
#undef SFM_SCHUR_MATVEC_ARGS

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
