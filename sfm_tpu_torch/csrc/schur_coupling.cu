// Kernel K10: the point coupling of the dense reduced (Schur) system.
//
// Replaces the assembly in sfm_tpu/ba/schur.py::dense_schur_direct (:348-418):
// there the per-slot blocks are scattered onto cameras by one-hot matmuls and
// the camera-pair coupling sum_p sum_{a,b in obs(p)} W_a V_p^-1 W_b^T is one
// (3P' x 6C)^T (3P' x 6C) matmul (an MXU trick), and the camera blocks are one
// scatter (:392). Here the kernels write the whole of S:
//   S[cam_a, cam_a] += U_c + diag(lambda D_c)
//   S[cam_a, cam_b] -= M_a Vinv_p M_b^T         (M_o = Jc_o^T Jp_o, B x 3)
//   S[cam_a, k]     += Jc_a^T Jk_a - M_a Vinv_p Wk_p^T  (Wk_p = sum_a Jk_a^T Jp_a)
//   S[k, k]          = Uk + diag(lambda_k) - sum_p Wk_p Vinv_p Wk_p^T
// with the transposed blocks mirrored, so S comes out symmetric.
//
// Every entry is an order-free 64-bit fixed-point sum (sfm_common.cuh), so S
// has the same bits whatever the order of its terms. Their bound needs no
// first pass: with d_r^2 the row's damped diagonal (U_ii + lambda D_ii, or
// Uk_jj + lambda_k), every term of entry (r, s) is at most sqrt(q_a,r q_b,s)
// (Cauchy-Schwarz, as Jp_a Vinv_p Jp_a^T <= I), and those add up to at most
// d_r d_s (2 d_r d_s on the k column). The shift maps 4 d_r d_s to 2^52,
// leaving 2^11 of headroom for points with two observations in one camera and
// for the rounding of Vinv; a term past 2^62 all the same (or a non-finite
// one) makes the whole S NaN, which the LM loop rejects like any failed
// solve. Each entry is rounded to T once.
//
// Templated on the camera block B (6, or 10 with per-camera intrinsics: S is
// (10C + 4)^2) and on the island's scalar T (float, or double with
// BAConfig.f64_normal_equations: the entries' sums take two words,
// sfm_common.cuh, at a shift 32 higher; S comes out double for cuSOLVER's
// f64 Cholesky). The Cauchy-Schwarz bound holds at any B: it only uses the
// damped diagonal of the row and the column.
//
// What bounded the first design on the H100: one 64-bit global atomic a term
// (two in f64): the 100-camera, 200k-observation scene has ~1.1M slot pairs x
// 36 terms onto 360k addresses, and each pair rebuilt both M blocks. Design
// now, over a layout that ba/schur.py::coupling_layout builds once a BA
// problem (the structure is fixed across LM trials):
//  1. the point pass, a warp a row of the per-point grouping
//     (schur.py::coobs_pairs): each valid slot's A_o = M_o Vinv_p, M_o and
//     its k-column term go to `terms` once, in rows of four for 16-byte
//     accesses (read back from L2); the S_kk terms of a block's points meet
//     in shared memory, then one global add a word. It also zeroes S (the
//     blocks no point couples stay 0) and writes each row's exponent.
//  2. the walk, a block a target block of S: a camera pair P <= Q walks its
//     run of slot pairs (sorted by target block), a camera's k block walks
//     its slots, the k-k block reads the point pass's sums. Threads take the
//     block's rows and keep their columns' integer sums in registers; each
//     group's sums go to shared memory (no atomics: 64-bit shared atomics
//     under contention cost a fifth of the walk), one thread an entry adds
//     them up, rounds the entry once, with the camera blocks and the shift
//     on the way, and writes it and its mirror. No global atomic a term, no
//     n^2 scratch. The last block to finish makes S NaN (all of it, or a
//     row and column whose diagonal is not finite) and clears the flags for
//     the next call.
// What bounds it now: the walk's blocks (one a camera pair: ~5,150 on the
// 100-camera scene) each pay a fixed latency, and every term two 64-bit
// conversions (float to double, double to integer).
// Each term keeps the first design's float expressions and operands: the
// term of slot pair a <= b is A of the lower slot times M of the higher, at
// (c_a, c_b) and mirrored, so any walk order gives the same words.
#include "sfm_common.cuh"

namespace {

constexpr int WARPS = 8;  // the point pass: a warp a grouping row
constexpr int NT = 32 * WARPS;
constexpr int WALK_NT = 256;  // the walk: a block a target block
constexpr int UNROLL = 2;     // slot pairs a group's step loads before it sums them
constexpr int PAIR_FLAGS = 30;  // a slot pair's orientation bits above its second slot

// A compile-time flag handed to a generic lambda.
template <bool V>
struct Flag {
  static constexpr bool value = V;
};

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

// Uk + diag(lambda_k) at (i, j), as the reference's S[k, k] starts.
template <typename T>
__device__ __forceinline__ T kk_base(const T* __restrict__ Uk, const T* __restrict__ lam_diag_k,
                                     int i, int j) {
  return Uk[i * 4 + j] + (i == j ? lam_diag_k[i] : T(0));
}

// d_r's exponent (d_r < 2^e) of row r of S: the damped camera diagonal, or
// the intrinsics block's.
template <int B, typename T>
__device__ __forceinline__ int row_exponent(const T* __restrict__ U,
                                            const T* __restrict__ lam_diag_c,
                                            const T* __restrict__ Uk,
                                            const T* __restrict__ lam_diag_k, int C, size_t r) {
  const T d2 = r < (size_t)B * C ? U[(r / B) * B * B + (r % B) * (B + 1)] + lam_diag_c[r]
                                 : kk_base<T>(Uk, lam_diag_k, (int)(r - (size_t)B * C),
                                              (int)(r - (size_t)B * C));
  int e = 0;
  if (!(d2 <= Fix<T>::DIAG_MAX)) {
    e = SFM_FX_BAD;
  } else {
    frexp(sqrt(fmax((double)d2, 0.0)), &e);
  }
  return e;
}

// Four values a row in `terms` (A and M rows padded with a 0), so a row is
// one 16-byte access (two in f64).
__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double x[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// An entry's shift k and 2^k where that is a normal double (x * 2^k then
// rounds as ldexp(x, k) does); k = NO_ENTRY when the row's or the column's
// exponent is not finite (the entry comes out NaN).
constexpr int NO_ENTRY = -2000000000;
__device__ __forceinline__ int entry_shift(int er, int es, int shift) {
  return er == SFM_FX_BAD || es == SFM_FX_BAD ? NO_ENTRY : shift - er - es;
}
__device__ __forceinline__ double entry_scale(int k) {
  return k >= -1022 && k <= 1023 ? ldexp(1.0, k) : 0.0;
}

// x added to an entry's words at its shift; a term out of bounds sets *bad.
// FAST: the entry is live and its 2^k a normal double (a block all of whose
// entries are, the common case, takes no branch a term).
template <typename T, bool FAST>
__device__ __forceinline__ void fx_term(unsigned long long& hi, unsigned long long& lo, T x,
                                        int k, double scale, int* bad) {
  if (!FAST && k == NO_ENTRY) return;
  const double v = FAST || scale != 0.0 ? (double)x * scale : ldexp((double)x, k);
  if (!(fabs(v) < Fix<T>::LIMIT)) {  // past the bound, or not finite
    *bad = 1;
    return;
  }
  const SfmFxQ q = sfm_fx_words<T>(v);
  hi += static_cast<unsigned long long>(q.hi);
  if (SfmFx<T>::WORDS == 2) lo += static_cast<unsigned long long>(q.lo);
}

// The point pass: A_o = M_o Vinv_p, M_o and the k-column terms of every valid
// slot into `terms` (the slots numbered row by row from row_slot[g]; three
// sections of Ov x B rows of 4: A, M, the k-column terms), the S_kk sums into
// kk; on the way it zeroes S and writes every row's exponent to er.
template <int B, typename T>
__global__ void __launch_bounds__(NT) coupling_point_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ Jp,
    const int* __restrict__ obs_point, const T* __restrict__ Vinv, const int* __restrict__ perm,
    const uint8_t* __restrict__ perm_valid, const int* __restrict__ row_slot,
    const T* __restrict__ U, const T* __restrict__ lam_diag_c, const T* __restrict__ Uk,
    const T* __restrict__ lam_diag_k, int C, int G, int Vs, int Ov, T* __restrict__ S,
    T* __restrict__ terms, unsigned long long* __restrict__ kk, int* __restrict__ ctrl,
    int* __restrict__ er) {
  constexpr int W = SfmFx<T>::WORDS;
  __shared__ unsigned long long s_kk[16 * W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + warp;
  const size_t n = (size_t)B * C + 4;
  const size_t stride = (size_t)gridDim.x * NT;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n * n; e += stride) S[e] = T(0);
  for (size_t r = (size_t)blockIdx.x * NT + threadIdx.x; r < n; r += stride)
    er[r] = row_exponent<B, T>(U, lam_diag_c, Uk, lam_diag_k, C, r);
  if (threadIdx.x < 16 * W) s_kk[threadIdx.x] = 0ull;

  int nv = 0;
  if (g < G)
    for (int s0 = 0; s0 < Vs; s0 += 32) {
      const int s = s0 + lane;
      nv += __popc(__ballot_sync(0xffffffffu, s < Vs && perm_valid[(size_t)g * Vs + s]));
    }
  __syncthreads();  // s_kk zeroed
  if (nv > 0) {
    const int* so = perm + (size_t)g * Vs;  // the valid slots lead the row
    T* const tA = terms + (size_t)row_slot[g] * B * 4;    // the row's first slot
    T* const tM = tA + (size_t)Ov * B * 4;
    T* const tK = tM + (size_t)Ov * B * 4;
    const int p = obs_point[so[0]];
    T Vi[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Vi[i][j] = Vinv[(size_t)p * 9 + i * 3 + j];

    for (int a = lane; a < nv; a += 32) {
      const int o = so[a];
      T Ma[B][3];
      coupling_block<B, T>(Jc, Jp, o, Ma);
#pragma unroll
      for (int i = 0; i < B; ++i) {
        T A[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          A[j] = Ma[i][0] * Vi[0][j] + Ma[i][1] * Vi[1][j] + Ma[i][2] * Vi[2][j];
        store4(tA + ((size_t)a * B + i) * 4, A[0], A[1], A[2], T(0));
        store4(tM + ((size_t)a * B + i) * 4, Ma[i][0], Ma[i][1], Ma[i][2], T(0));
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
#pragma unroll
      for (int i = 0; i < B; ++i) {
        T x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[j] = jc[i] * jk[j] + jc[B + i] * jk[4 + j] -
                 (Ma[i][0] * AkT[0][j] + Ma[i][1] * AkT[1][j] + Ma[i][2] * AkT[2][j]);
        store4(tK + ((size_t)a * B + i) * 4, x[0], x[1], x[2], x[3]);
      }
    }
    if (lane < 16) {
      const int i = lane / 4, j = lane % 4;
      // wk and AkT indexed by unrolled loops only, so they stay in registers.
      T x = T(0);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (ii == i && jj == j)
            x = wk[ii * 3] * AkT[0][jj] + wk[ii * 3 + 1] * AkT[1][jj] + wk[ii * 3 + 2] * AkT[2][jj];
      const int ea = row_exponent<B, T>(nullptr, nullptr, Uk, lam_diag_k, C, n - 4 + i);
      const int eb = row_exponent<B, T>(nullptr, nullptr, Uk, lam_diag_k, C, n - 4 + j);
      const double v = ldexp(-(double)x, Fix<T>::SHIFT - ea - eb);
      if (ea == SFM_FX_BAD || eb == SFM_FX_BAD) {
      } else if (!(fabs(v) < Fix<T>::LIMIT)) {
        atomicOr(&ctrl[1], 1);
      } else {
        sfm_fx_add_q<T>(s_kk, 16, lane, sfm_fx_words<T>(v));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 16 * W && s_kk[threadIdx.x] != 0ull) atomicAdd(&kk[threadIdx.x], s_kk[threadIdx.x]);
}

// The walk: block `blockIdx.x` of `items` ((P, Q, start, end): camera rows P,
// columns Q, camera C standing for the intrinsics rows; a run of `pairs`, or
// of `cam_slots` for a k block), summed, rounded and written with its mirror.
// A thread takes a row r of the block and keeps its columns' words in
// registers; groups of B threads take the run's pairs in turn, two at a time.
template <int B, typename T>
__global__ void __launch_bounds__(WALK_NT) coupling_walk_kernel(
    const T* __restrict__ U, const T* __restrict__ lam_diag_c, const T* __restrict__ Uk,
    const T* __restrict__ lam_diag_k, const int2* __restrict__ pairs,
    const int4* __restrict__ items, const int* __restrict__ cam_slots,
    const T* __restrict__ terms, int C, int Ni, int Ov, T* __restrict__ S,
    unsigned long long* __restrict__ kk, int* __restrict__ ctrl, const int* __restrict__ er) {
  constexpr int W = SfmFx<T>::WORDS;
  constexpr int NG = WALK_NT / B;  // groups of B threads, a thread a row of the block
  __shared__ int s_er[2 * B];      // the rows' exponents, then the columns'
  __shared__ int s_k[B * B];       // each entry's shift (entry_shift)
  __shared__ double s_scale[B * B];
  __shared__ unsigned long long s_part[W][NG][B * B];  // each group's words, then their sums
  __shared__ int s_last;
  const int4 it = items[blockIdx.x];
  const int P = it.x, Q = it.y;
  const size_t n = (size_t)B * C + 4, kc = (size_t)B * C;
  const int nr = P < C ? B : 4, ncol = Q < C ? B : 4;
  const size_t R0 = P < C ? (size_t)P * B : kc, C0 = Q < C ? (size_t)Q * B : kc;
  const int tid = threadIdx.x;
  if (tid < nr) s_er[tid] = er[R0 + tid];
  if (tid >= B && tid < B + ncol) s_er[tid] = er[C0 + tid - B];
  __syncthreads();
  bool plain = true;
  if (tid < nr * ncol) {
    const int k = entry_shift(s_er[tid / ncol], s_er[B + tid % ncol], Fix<T>::SHIFT);
    s_k[tid] = k;
    s_scale[tid] = entry_scale(k);
    plain = k != NO_ENTRY && s_scale[tid] != 0.0;
  }
  const bool fast = __syncthreads_and(plain);  // every entry live, every 2^k normal

  int bad = 0;
  const int grp = tid / B, r = tid % B;
  const T* const tA = terms;
  const T* const tM = terms + (size_t)Ov * B * 4;
  const T* const tK = tM + (size_t)Ov * B * 4;
  if (Q < C && grp < NG) {  // a camera pair's block: its slot pairs
    unsigned long long hi[B], lo[B];
#pragma unroll
    for (int c = 0; c < B; ++c) hi[c] = lo[c] = 0ull;
    // The terms of slot pair pr, on this thread's row r.
    auto pair_terms = [&](int2 pr, auto fast_tag) {
      constexpr bool F = decltype(fast_tag)::value;
      const int fl = (int)((unsigned)pr.y >> PAIR_FLAGS);
      const T* Aa = tA + (size_t)pr.x * B * 4;
      const T* Mb = tM + (size_t)(pr.y & ((1 << PAIR_FLAGS) - 1)) * B * 4;
      T own[4];
      if (fl & 1) {  // (c_a + r, c_b + c) from A_a's row r and M_b's row c
        load4(Aa + r * 4, own);
#pragma unroll
        for (int c = 0; c < B; ++c) {
          T m[4];
          load4(Mb + c * 4, m);
          const T x = own[0] * m[0] + own[1] * m[1] + own[2] * m[2];
          fx_term<T, F>(hi[c], lo[c], -x, s_k[r * B + c], s_scale[r * B + c], &bad);
        }
      }
      if (fl & 2) {  // the mirror (c_b + r, c_a + c) from A_a's row c and M_b's row r
        load4(Mb + r * 4, own);
#pragma unroll
        for (int c = 0; c < B; ++c) {
          T a[4];
          load4(Aa + c * 4, a);
          const T x = a[0] * own[0] + a[1] * own[1] + a[2] * own[2];
          fx_term<T, F>(hi[c], lo[c], -x, s_k[r * B + c], s_scale[r * B + c], &bad);
        }
      }
    };
    auto run = [&](auto fast_tag) {
      int k = it.z + grp;
      for (; k + (UNROLL - 1) * NG < it.w; k += UNROLL * NG) {
        int2 pr[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) pr[u] = pairs[k + u * NG];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) pair_terms(pr[u], fast_tag);
      }
      for (; k < it.w; k += NG) pair_terms(pairs[k], fast_tag);
    };
    if (fast)
      run(Flag<true>());
    else
      run(Flag<false>());
#pragma unroll
    for (int c = 0; c < B; ++c) {
      s_part[0][grp][r * B + c] = hi[c];
      if (W == 2) s_part[W - 1][grp][r * B + c] = lo[c];
    }
  } else if (P < C && grp < NG) {  // camera P's k block: its slots' terms
    unsigned long long hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) hi[j] = lo[j] = 0ull;
    for (int k = it.z + grp; k < it.w; k += NG) {
      T t[4];
      load4(tK + ((size_t)cam_slots[k] * B + r) * 4, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fx_term<T, false>(hi[j], lo[j], t[j], s_k[r * 4 + j], s_scale[r * 4 + j], &bad);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s_part[0][grp][r * 4 + j] = hi[j];
      if (W == 2) s_part[W - 1][grp][r * 4 + j] = lo[j];
    }
  } else if (P == C && tid < 16) {  // the k-k block: the point pass's sums
    s_part[0][0][tid] = kk[tid];
    kk[tid] = 0ull;
    if (W == 2) {
      s_part[W - 1][0][tid] = kk[16 + tid];
      kk[16 + tid] = 0ull;
    }
  }
  if (bad) atomicOr(&ctrl[1], 1);
  __syncthreads();
  // The groups' words of each entry summed (integers: any order).
  if (tid < nr * ncol && P < C) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned long long sum = s_part[w][0][tid];
      for (int g = 1; g < NG; ++g) sum += s_part[w][g][tid];
      s_part[w][0][tid] = sum;
    }
  }

  // Each entry: what the reference starts S with (the camera block on the
  // diagonal, Uk + diag(lambda_k) at k-k), plus its sum, rounded to T once.
  if (tid < nr * ncol) {
    const int i = tid / ncol, j = tid % ncol;
    double v = P == C ? (double)kk_base<T>(Uk, lam_diag_k, i, j) : 0.0;
    if (P == Q && P < C)
      v += (double)(U[(size_t)P * B * B + i * B + j] + (i == j ? lam_diag_c[(size_t)P * B + i] : T(0)));
    const int sh = s_k[tid];
    if (sh == NO_ENTRY) {
      v = __longlong_as_double(0x7ff8000000000000ll);
    } else {
      const unsigned long long hi = s_part[0][0][tid];
      v += W == 1 ? sfm_fx_value(hi, sh) : sfm_fx_value2(hi, s_part[W - 1][0][tid], sh);
    }
    S[(R0 + i) * n + C0 + j] = (T)v;
    if (P != Q) S[(C0 + j) * n + R0 + i] = (T)v;
  }

  // The last block: S all NaN after a term out of bounds; else the rows and
  // columns whose diagonal is not finite (the blocks no item writes too).
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the block's writes, ordered by the barrier, before the count
    s_last = atomicAdd(&ctrl[0], 1) == Ni - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const T nan = (T)__longlong_as_double(0x7ff8000000000000ll);
  if (atomicAdd(&ctrl[1], 0) != 0) {
    for (size_t e = tid; e < n * n; e += WALK_NT) S[e] = nan;
  } else {
    for (size_t rr = tid; rr < n; rr += WALK_NT) {
      if (er[rr] != SFM_FX_BAD) continue;
      for (size_t c = 0; c < n; ++c) {
        S[rr * n + c] = nan;
        S[c * n + rr] = nan;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    ctrl[0] = 0;
    ctrl[1] = 0;
  }
}

// pairs (Np, 2), items (Ni, 4), cam_slots (Ov), row_slot: ba/schur.py::
// coupling_layout; terms: 12 B x Ov of T; kk: WORDS x 16 uint64 and
// ctrl: 2 int32, zero between calls (the walk's last block clears them); er:
// n int32, the rows' exponents. S (n x n, n = BC + 4) is written whole.
template <int B, typename T>
int schur_coupling(const void* Jc, const void* Jk, const void* Jp, const void* obs_point,
                   const void* Vinv, const void* perm, const void* perm_valid, const void* U,
                   const void* lam_diag_c, const void* Uk, const void* lam_diag_k,
                   const void* pairs, const void* items, const void* cam_slots,
                   const void* row_slot, int C, int G, int Vs, int Ni, int Ov, void* S,
                   void* terms, void* kk, void* ctrl, void* er, cudaStream_t st) {
  int* flags = static_cast<int*>(ctrl);
  // At least one block: the point pass also zeroes S and writes the exponents.
  const int point_blocks = G > 0 ? (G + WARPS - 1) / WARPS : 1;
  coupling_point_kernel<B, T><<<point_blocks, NT, 0, st>>>(
      static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(Jp),
      static_cast<const int*>(obs_point), static_cast<const T*>(Vinv),
      static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid),
      static_cast<const int*>(row_slot), static_cast<const T*>(U),
      static_cast<const T*>(lam_diag_c), static_cast<const T*>(Uk),
      static_cast<const T*>(lam_diag_k), C, G, Vs, Ov, static_cast<T*>(S),
      static_cast<T*>(terms), static_cast<unsigned long long*>(kk), flags,
      static_cast<int*>(er));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || Ni <= 0) return static_cast<int>(e);
  coupling_walk_kernel<B, T><<<Ni, WALK_NT, 0, st>>>(
      static_cast<const T*>(U), static_cast<const T*>(lam_diag_c), static_cast<const T*>(Uk),
      static_cast<const T*>(lam_diag_k), static_cast<const int2*>(pairs),
      static_cast<const int4*>(items), static_cast<const int*>(cam_slots),
      static_cast<const T*>(terms), C, Ni, Ov, static_cast<T*>(S),
      static_cast<unsigned long long*>(kk), flags, static_cast<const int*>(er));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SFM_SCHUR_COUPLING(NAME, B, T)                                                        \
  SFM_API int NAME(const void* Jc, const void* Jk, const void* Jp, const void* obs_point,     \
                   const void* Vinv, const void* perm, const void* perm_valid, const void* U, \
                   const void* lam_diag_c, const void* Uk, const void* lam_diag_k,            \
                   const void* pairs, const void* items, const void* cam_slots,               \
                   const void* row_slot, int C, int G, int Vs, int Ni, int Ov, void* S,       \
                   void* terms, void* kk, void* ctrl, void* er, void* stream) {               \
    return schur_coupling<B, T>(Jc, Jk, Jp, obs_point, Vinv, perm, perm_valid, U, lam_diag_c, \
                                Uk, lam_diag_k, pairs, items, cam_slots, row_slot, C, G, Vs,  \
                                Ni, Ov, S, terms, kk, ctrl, er,                               \
                                static_cast<cudaStream_t>(stream));                           \
  }
SFM_SCHUR_COUPLING(sfm_schur_coupling, 6, float)
SFM_SCHUR_COUPLING(sfm_schur_coupling_b10, 10, float)
SFM_SCHUR_COUPLING(sfm_schur_coupling_f64, 6, double)
SFM_SCHUR_COUPLING(sfm_schur_coupling_b10_f64, 10, double)
#undef SFM_SCHUR_COUPLING
