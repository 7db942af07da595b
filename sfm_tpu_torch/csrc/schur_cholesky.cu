// Kernel K10, the dense BA step's Cholesky factorization and solve (two
// entries: sfm_schur_cholesky_solve, float; sfm_schur_cholesky_solve_f64,
// double; both camera blocks, B = 6 and 10, since only n and the type matter).
//
// Replaces jax.scipy.linalg.cho_solve(cho_factor(S + _EPS I), rhs) in
// sfm_tpu/ba/schur.py::dense_schur_direct (:420-423; the same solve closes
// ::dense_schur_solve, :452-455), which XLA ran as a blocked Cholesky and two
// triangular solves.
//
// What it computes: x = (S + eps I)^-1 [rhs_c; rhs_k] for the n x n reduced
// camera system S (n = B C + 4; only its lower triangle is read), eps added to
// each diagonal entry as it is loaded, in the working type T (the reference's
// S + _EPS I). x is one n-vector, which the wrapper views as (C, B) and (4,).
// If any pivot is not > 0 (S not positive definite, or a NaN in it) every
// entry of x is NaN, and LM's cost test rejects the step (ba/lm.py).
//
// Precision. The factor L and y = L^-1 rhs are kept in double for both
// types, every sum in double (the rank-k products on the float64 tensor
// cores, mma.m8n8k4.f64, which round each product-sum as an FMA does), and
// only x is rounded to T, once: in the float route x is then (nearly) the
// correctly rounded solution of the float S, whatever the blocking or the
// order of the sums, so the plain twin (ba/schur.py::dense_solve_plain, the
// same panels and rules) gives the same bits but where the two solutions
// straddle a rounding boundary. No TF32, no bf16. Below a pivot d a column's
// entries are a * rsqrt(d); the stored pivot is sqrt(d), which the
// back-substitution divides by.
//
// Storage: in the double route the factor overwrites S's lower triangle and
// y (then x, in double) lives in x (schur_matrix_cuda makes a fresh S every
// call, and no caller reads S after the solve); in the float route they go
// to the wrapper's double workspace (L: n x n, y: n) and S is only read.
//
// Design: one persistent cooperative launch, a block an SM, all resident
// (cudaLaunchCooperativeKernel, the grid G from the occupancy calculator); one
// compiled body for both types (T only at the input and at x, a run-time
// flag: two instantiations allocate their registers apart, and one of them
// ran slower); left-looking over panels of W = 32 columns, one grid barrier
// a panel. Row i of the augmented matrix [S; rhs^T] belongs to row group
// i mod Gv (at most RMAX = 32 rows), and row group v to block v mod G; row n
// is the right-hand side, so the forward substitution L y = rhs rides along
// as one more row (its entries go to y). Gv = G up to n = G RMAX - 1 (4,223
// on 132 SMs); past that a block runs its groups one after the other in each
// step, with nothing but its shared memory to carry between them (a group's
// sums are in the workspace, its entries in L). Panel k's step:
//  1. every thread loads the diagonal tile's sums D: the entries of S (+ eps)
//     less the next-panel products the step before left in the workspace
//     (q slices a row, added in order); the tile rows' panel k - 1 entries
//     TP come back from L with cp.async, and warps 0-5 take panel k - 1's
//     terms off D as 16 x 8 tiles of a product on the float64 tensor cores
//     (mma.m16n8k8.f64, Hopper's own shape);
//  2. warp 0 factors the 32 x 32 tile, redundantly in every block: a lane a
//     row in registers, right-looking in sub-panels of 8 columns (shuffles
//     inside a sub-panel, a rank-8 update from shared memory after it), no
//     branch in the pivot chain; it hands each sub-panel to warp 1 (named
//     barriers 2-5). Warps 1 and 4 first form the own rows' sums A below
//     the tile the same way (their panel k - 1 entries LO against TP), then
//     warp 1 solves those rows, a lane a row, trailing the pivot chain by a
//     sub-panel, and writes them to L;
//  3. warps 2, 3, 5, 6 and 7 compute the block's units of the next panel's
//     products: the rows from the next tile down (its own rows included) in
//     row blocks of 32 consecutive rows, each against the next tile's rows
//     over the finished columns, on the tensor cores, each warp taking every
//     fifth 8-column step of a chunk and the warps' sums meeting in shared
//     memory. A row block's columns are cut into q slices (1 to 8: the q
//     that leaves the least to the busiest block) so that every block has
//     work while row blocks are few; unit rb q + s goes to block (rb q + s)
//     mod G, stages only its slice (160-column chunks, two buffers, a 1-D
//     bulk copy (TMA) a row, an mbarrier a buffer), and leaves its partial
//     sums in the workspace for step 1 of the next panel.
// After the last panel, one more barrier; then the back-substitution over
// the grid, a panel a block (block b takes panels K - 1 - b, K - 1 - b - G,
// ...), split so that the hand-off of x_{k+1}, which each panel waits for,
// is one 32 x 32 product: x_k = u - M x_{k+1}, u = L_kk^-T (y_k - sum over
// j > k + 1 of L_jk^T x_j) (each warp summing the panels j of its residue
// class mod 8 as their x_j arrive, the L_jk block loaded before x_j is
// polled) and M = L_kk^-T L_{k+1,k}^T, both formed while x_{k+1} is on its
// way. x is handed on through the workspace, each entry a signalling NaN
// until written, polled with relaxed loads: no fence, no flag.
// What another block wrote is read through L2 (__ldcg, cp.async.cg, bulk
// copies): L1 is not coherent across SMs. Block 0 writes each diagonal tile
// of L a step late, once every block has read S's tile. Deterministic: every sum in a
// fixed order, no atomics; it synchronises nothing on the host and allocates
// nothing (the partial sums, the handed-over x and the float route's factor
// are the wrapper's workspace).
//
// What bounds it on the H100: the operations, n^3 / 3 + 2 n^2 (0.25 GFLOP at
// n = 904) at 67 TFLOP/s (float64 on the tensor cores), ~4 us; the bytes, S
// read and x written once (3.3 MB at n = 904), ~1 us. What holds it back is
// the chain: n / 32 grid barriers, each panel's tile sums and pivot chain of
// 32 columns (a shuffle, a double rsqrt and two FMAs a column), and the
// back-substitution's n / 32 hand-offs; past n ~ 2,000 the next panel's
// products, whose 160-column chunks take longer than the chain.
#include <cooperative_groups.h>

#include "sfm_common.cuh"

namespace cg = cooperative_groups;

#ifdef SFM_CHOL_STAMPS
// tests/dense_solve_stamps.py: [G][K][8] cycle counts a panel, then 4 a block.
__device__ unsigned long long* g_stamps;
#endif

namespace {

constexpr int W = 32;                 // panel width: a warp's lanes
constexpr int WP = W + 1;             // a padded row (the tile's and the own rows' sums)
constexpr int LTP = W + 2;            // a row read as 16-byte pairs (LT, the back-substitution's)
constexpr int FP = W + 4;             // a row read as tensor-core fragments (conflict-free)
constexpr int NT = 256;               // threads a block
constexpr int NWARP = NT / 32;
// The bulk warps, 2, 3, 5, 6 and 7: the next panel's products (warps 1 and
// 4 sum the own rows, warp 0 factors the tile).
constexpr int NBULK = 5;
__device__ __forceinline__ int bulk_index(int warp) {
  return warp < 2 || warp == 4 ? -1 : warp - 2 - (warp > 4);
}
constexpr int RMAX = 32;              // rows a row group holds at most (the rhs row included)
constexpr int QMAX = 8;               // column slices of a row block's products at most
constexpr int MC = 160;               // columns a staged chunk
constexpr int SP = MC + 4;            // a staged row (even: 16-byte copies; 4 mod 16: fragments)
constexpr int NSTAGE = 2;             // staged chunks: one in flight while one is summed
constexpr int SUB = 8;                // columns a sub-panel of the tile's factorization
constexpr unsigned FULL = 0xffffffffu;
static_assert(RMAX <= 32, "the row solve takes a lane a row");

// Shared memory, in doubles.
constexpr int SM_D = 0;                       // [W][WP] the diagonal tile's sums
constexpr int SM_LT = SM_D + W * WP;          // [W][LTP] LT[t][p] = L[j0 + p][j0 + t]
constexpr int SM_TP = SM_LT + W * LTP;        // [W][FP] TP[q][m] = L[j0 + q][j0 - W + m]
constexpr int SM_LO = SM_TP + W * FP;         // [RMAX][FP] own rows' panel k - 1 entries, then k's
constexpr int SM_A = SM_LO + RMAX * FP;       // [RMAX][WP] own rows' sums
constexpr int SM_R = SM_A + RMAX * WP;        // [W] rsqrt of the pivots; 1 / L[t][t] (back-sub.)
constexpr int SM_ST = SM_R + W;               // [NSTAGE][2 W][SP] staged chunks; partials
constexpr int STAGE = 2 * W * SP;
constexpr int SM_END = SM_ST + NSTAGE * STAGE;
// Then the failure flag and the staging buffers' mbarriers.
constexpr int SMEM_BYTES = SM_END * 8 + 16 + 8 * NSTAGE;
static_assert(SM_ST % 2 == 0, "16-byte copies into the staging buffers");
static_assert(NBULK * RMAX * WP <= NSTAGE * STAGE, "the bulk warps' partials reuse the staging");
static_assert(NWARP * W <= W * WP, "the back-substitution's partial z reuse D");

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bulk_sync() {  // the bulk warps only
  bar_sync(1, NBULK * 32);
}

// d += a b on the tensor cores: one m16n8k8 float64 product, Hopper's own
// shape (A row-major 16 x 8, B column-major 8 x 8). With g = lane / 4 and
// t = lane % 4, a lane holds A[g + 8 (i % 2)][t + 4 (i / 2)] in a[i],
// B[t + 4 i][g] in b[i] and D[g + 8 (i / 2)][2 t + i % 2] in d[i].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The A fragment of rows m0 .. m0 + 15, columns c0 .. c0 + 7 of X (row
// stride s), times sign; the B fragment of rows n0 .. n0 + 7 of Y (B = Y^T).
__device__ __forceinline__ void frag_a(double (&a)[4], const double* X, int s, int m0, int c0,
                                       int lane, double sign) {
  const double* x = X + (m0 + (lane >> 2)) * s + c0 + (lane & 3);
  a[0] = sign * x[0];
  a[1] = sign * x[8 * s];
  a[2] = sign * x[4];
  a[3] = sign * x[8 * s + 4];
}

__device__ __forceinline__ void frag_b(double (&b)[2], const double* Y, int s, int n0, int c0,
                                       int lane) {
  const double* y = Y + (n0 + (lane >> 2)) * s + c0 + (lane & 3);
  b[0] = y[0];
  b[1] = y[4];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// The staging ring's mbarriers (one a buffer): a 1-D bulk copy (the TMA)
// a staged row segment, the buffer's barrier expecting their bytes.

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(double* dst, const double* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the barrier's phase of the given parity (a copy that never lands
// is a fault: trap after ~10^8 polls rather than hang).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  for (long long polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1ll << 27)) __trap();
  }
}

// The back-substitution hands x_j from block to block through xs, each entry
// set to a NaN that no arithmetic makes (a signalling payload) at the start:
// a reader polls its entry until it is not that NaN any more. The entry is
// the only datum handed over, so relaxed loads and stores do (every block is
// resident, so the value comes; ~10^8 polls is a fault, and traps rather
// than hangs).
constexpr unsigned long long XS_UNSET = 0x7ff4dead0badf00dull;

__device__ __forceinline__ double poll_x(const double* p) {
  unsigned long long v;
  for (long long polls = 0;; ++polls) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    if (v != XS_UNSET) return __longlong_as_double(static_cast<long long>(v));
    if (polls > (1ll << 27)) __trap();
  }
}

__device__ __forceinline__ void put_x(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p),
               "l"(static_cast<unsigned long long>(__double_as_longlong(v)))
               : "memory");
}

// The first own row r (row b + r G) at or past row lo.
__device__ __forceinline__ int first_row(int lo, int b, int G) {
  return lo <= b ? 0 : (lo - b + G - 1) / G;
}

// Row i of the factor's storage (double): L's row, or y for the rhs row.
__device__ __forceinline__ double* lrow(double* L, double* y, int n, int i) {
  return i < n ? L + (size_t)i * n : y;
}

// The column slices q of panel j's row blocks (32 rows each, from row j):
// the q (1 .. QMAX) whose rb q units leave the fewest columns to the block
// that takes the most of them, ceil(rb q / G) / q; the smaller q on a tie.
__device__ __forceinline__ int slices_of(int n, int j, int G) {
  const int rb = (n + 1 - j + W - 1) / W;
  int best = 1;
  for (int q = 2; q <= QMAX; ++q)
    if ((rb * q + G - 1) / G * best < (rb * best + G - 1) / G * q) best = q;
  return best;
}

// Slice s of the next-panel products of row i, column p (two steps' worth:
// par, the parity of the step that reads them).
__device__ __forceinline__ double* part_at(double* part, int n, int par, int s, int i, int p) {
  return part + (((size_t)par * QMAX + s) * (n + 1) + i) * W + p;
}

// The products of row i, column p: its row block's q slices, added in order
// (every load issued before the sum; + 0.0 past the q slices leaves the sum
// as it is).
__device__ __forceinline__ void load_slices(double (&pv)[QMAX], double* part, int n, int par,
                                            int q, bool ok, int i, int p) {
#pragma unroll
  for (int s = 0; s < QMAX; ++s) pv[s] = ok && s < q ? __ldcg(part_at(part, n, par, s, i, p)) : 0.0;
}

__device__ __forceinline__ double slices_sum(const double (&pv)[QMAX]) {
  double v = pv[0];
#pragma unroll
  for (int s = 1; s < QMAX; ++s) v += pv[s];
  return v;
}

// The input and the output in their own type T (float or double; one
// compiled body serves both types, the type a run-time flag).
struct Io {
  const void* S;
  const void* rc;
  const void* rk;
  void* x;
  double eps;
  int f32;
};

// Entry (i, j) of the augmented input [S + eps I; rhs^T] in T (one load, no
// branch: the address is chosen).
template <typename T>
__device__ __forceinline__ double input_t(const Io& io, int n, int bc, int i, int j) {
  const T* src = i < n ? static_cast<const T*>(io.S) + (size_t)i * n + j
                       : (j < bc ? static_cast<const T*>(io.rc) + j
                                 : static_cast<const T*>(io.rk) + (j - bc));
  const T v = __ldcg(src);
  return (double)(i == j ? v + (T)io.eps : v);  // S + eps I, the add in T
}

// x[j] = v, rounded to T once.
__device__ __forceinline__ void store_x(const Io& io, int j, double v) {
  if (io.f32)
    static_cast<float*>(io.x)[j] = (float)v;
  else
    static_cast<double*>(io.x)[j] = v;
}

// a[p] -= l * row[p] for the compile-time range [P0, P1) of p, reading
// row as 16-byte pairs where they are aligned (P0 and the row even).
template <int P0, int P1>
__device__ __forceinline__ void axpy_row(double (&a)[W], double l, const double* row) {
  if constexpr (P0 < P1) {
    if constexpr (P0 % 2 == 1 || P0 + 1 == P1) {
      a[P0] = fma(-l, row[P0], a[P0]);
      axpy_row<P0 + 1, P1>(a, l, row);
    } else {
      const double2 v = *reinterpret_cast<const double2*>(row + P0);
      a[P0] = fma(-l, v.x, a[P0]);
      a[P0 + 1] = fma(-l, v.y, a[P0 + 1]);
      axpy_row<P0 + 2, P1>(a, l, row);
    }
  }
}

// The same for p from P1 - 1 down to P0: the back-substitution's next entry
// (P1 - 1) first, off the issue of the rest.
template <int P0, int P1>
__device__ __forceinline__ void axpy_row_down(double (&a)[W], double l, const double* row) {
  if constexpr (P0 < P1) {
    if constexpr (P1 % 2 == 1 || P0 + 1 == P1) {
      a[P1 - 1] = fma(-l, row[P1 - 1], a[P1 - 1]);
      axpy_row_down<P0, P1 - 1>(a, l, row);
    } else {
      const double2 v = *reinterpret_cast<const double2*>(row + P1 - 2);
      a[P1 - 1] = fma(-l, v.y, a[P1 - 1]);
      a[P1 - 2] = fma(-l, v.x, a[P1 - 2]);
      axpy_row_down<P0, P1 - 2>(a, l, row);
    }
  }
}

// Warp 0: factor the w x w tile D (lower, double) into LT (L transposed)
// and R (rsqrt of each pivot); lane q holds row q in registers. Right-looking
// in sub-panels of SUB columns: column t's entries reach the lanes by
// shuffles for the rest of its own sub-panel, and the later sub-panels take a
// finished one as a rank-SUB update read from LT (16 bytes a load). Every
// entry still takes its terms in column order. A ragged tile is padded with
// unit rows, so all 32 steps run without a branch, and the padding touches
// no real entry. The pivot d waits in LT's diagonal until the end, when each
// lane takes its own sqrt(d). With `signal`, each finished sub-panel (its LT
// rows and R) is handed to warp 1 through named barrier 2 + sub-panel.
template <int S0>
__device__ __forceinline__ void factor_sub(double (&a)[W], double& diag, bool& bad, double* LT,
                                           double* R, int w, int lane, bool signal) {
  double ls[SUB];
#pragma unroll
  for (int tt = 0; tt < SUB; ++tt) {
    const int t = S0 + tt;
    const double d = __shfl_sync(FULL, diag, t);
    bad |= t < w && !(d > 0.0);
    const double r = rsqrt(d);
    const double l = a[t] * r;
    ls[tt] = l;
    // No branch: lanes above t write entries nobody reads (LT's upper part).
    LT[t * LTP + lane] = lane == t ? d : l;
    diag = lane > t ? fma(-l, l, diag) : diag;
    if (lane == 0) R[t] = r;
#pragma unroll
    for (int p = t + 1; p < S0 + SUB; ++p) a[p] = fma(-l, __shfl_sync(FULL, l, p), a[p]);
  }
  if (signal) {
    __threadfence_block();
    __syncwarp();
    bar_arrive(2 + S0 / SUB, 64);
  }
  if constexpr (S0 + SUB < W) {
    __syncwarp();
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt) axpy_row<S0 + SUB, W>(a, ls[tt], LT + (S0 + tt) * LTP);
  }
}

__device__ __forceinline__ void factor_tile(const double* D, double* LT, double* R, int w,
                                            int lane, int* bad_flag, bool signal) {
  double a[W];
#pragma unroll
  for (int p = 0; p < W; ++p) a[p] = (lane < w && p <= lane) ? D[lane * WP + p] : 0.0;
  double diag = lane < w ? D[lane * WP + lane] : 1.0;
  bool bad = false;
  factor_sub<0>(a, diag, bad, LT, R, w, lane, signal);
  factor_sub<8>(a, diag, bad, LT, R, w, lane, signal);
  factor_sub<16>(a, diag, bad, LT, R, w, lane, signal);
  factor_sub<24>(a, diag, bad, LT, R, w, lane, signal);
  __syncwarp();
  if (lane < w) LT[lane * LTP + lane] = sqrt(LT[lane * LTP + lane]);
  if (bad && lane == 0) *bad_flag = 1;
}

// An own row's substitution against the tile, columns T0 .. T1 - 1 (a lane a
// row): its entry t is a[t] r_t (kept in a[t]), then column t's terms leave
// the later entries.
template <int T0, int T1>
__device__ __forceinline__ void solve_cols(double (&a)[W], const double* LT, const double* R) {
  if constexpr (T0 < T1) {
    const double l = a[T0] * R[T0];
    a[T0] = l;
    axpy_row<T0 + 1, W>(a, l, LT + T0 * LTP);
    solve_cols<T0 + 1, T1>(a, LT, R);
  }
}

// The back-substitution's triangle, steps T0 down to 0 (every lane the
// same): x_t = z[t] / L[t][t], then row t's terms leave z[0 .. t).
template <int T0>
__device__ __forceinline__ void solve_triangle(double (&zz)[W], const double* Ls,
                                               const double* rinv, int lane, double& mine) {
  if constexpr (T0 >= 0) {
    const double xt = zz[T0] * rinv[T0];
    mine = lane == T0 ? xt : mine;
    axpy_row_down<0, T0>(zz, xt, Ls + T0 * LTP);
    solve_triangle<T0 - 1>(zz, Ls, rinv, lane, mine);
  }
}

// The same triangle for a lane's own right-hand side (every lane its own):
// zz becomes L_kk^-T zz in place.
template <int T0>
__device__ __forceinline__ void solve_columns(double (&zz)[W], const double* Ls,
                                              const double* rinv) {
  if constexpr (T0 >= 0) {
    zz[T0] *= rinv[T0];
    axpy_row_down<0, T0>(zz, zz[T0], Ls + T0 * LTP);
    solve_columns<T0 - 1>(zz, Ls, rinv);
  }
}

// Block 0: L's diagonal tile at row and column j0 (w x w) from LT into L.
__device__ __forceinline__ void write_tile(double* L, int n, int j0, int w, const double* LT) {
  for (int e = threadIdx.x; e < W * W; e += NT) {
    const int p = e / W, t = e % W;
    if (p < w && t <= p) L[(size_t)(j0 + p) * n + j0 + t] = LT[t * LTP + p];
  }
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Rows [j0 + q] of L, columns j0 - W .. j0 - 1 (panel k - 1's entries), into
// X[q][.] for q < nrow, from first row r0 with row stride rs (in the matrix):
// 16-byte copies where every row starts aligned (n even), else plain loads.
__device__ __forceinline__ void copy_panel(double* X, const double* L, const double* y, int n,
                                           int r0, int rs, int nrow, int j0, int t, int nt) {
  if ((n & 1) == 0) {
    for (int e = t; e < nrow * (W / 2); e += nt) {
      const int q = e / (W / 2), c = 2 * (e % (W / 2));
      cp16(X + q * FP + c, lrow(const_cast<double*>(L), const_cast<double*>(y), n,
                                r0 + q * rs) + j0 - W + c);
    }
  } else {
    for (int e = t; e < nrow * W; e += nt) {
      const int q = e / W, c = e % W;
      X[q * FP + c] = __ldcg(lrow(const_cast<double*>(L), const_cast<double*>(y), n,
                                  r0 + q * rs) + j0 - W + c);
    }
  }
}

// C -= X Y^T for one 16 x 8 tile (rows 16 mt of X, rows 8 nt of Y, 32
// columns) on the tensor cores; C is read from and written to out (row
// stride WP).
__device__ __forceinline__ void tile_terms(double* out, const double* X, const double* Y, int mt,
                                           int nt, int lane) {
  double* o = out + (16 * mt + (lane >> 2)) * WP + 8 * nt + 2 * (lane & 3);
  double c[4] = {o[0], o[1], o[8 * WP], o[8 * WP + 1]};
#pragma unroll
  for (int ks = 0; ks < W / 8; ++ks) {
    double a[4], b[2];
    frag_a(a, X, FP, 16 * mt, 8 * ks, lane, -1.0);
    frag_b(b, Y, FP, 8 * nt, 8 * ks, lane);
    dmma(c, a, b);
  }
  o[0] = c[0];
  o[1] = c[1];
  o[8 * WP] = c[2];
  o[8 * WP + 1] = c[3];
}

// Step 1 of panel k, the diagonal tile's sums D (every thread): the input
// less the products in the workspace, every load issued before any is used,
// then less panel k - 1's terms (TP TP^T: D's 6 lower 16 x 8 tiles on the
// tensor cores, a warp each).
template <typename T>
__device__ __forceinline__ void tile_sums(const Io& io, int n, int bc, const double* L,
                                          const double* y, double* part, int q, int par, int k,
                                          int j0, int w, double* sm) {
  constexpr int TRI = W * (W + 1) / 2, PER = (TRI + NT - 1) / NT;
  const int tid = threadIdx.x, warp = tid >> 5;
  double* D = sm + SM_D;
  double* TP = sm + SM_TP;
  if (k > 0) copy_panel(TP, L, y, n, j0, 1, w, j0, tid, NT);
  cp_commit();
  double v[PER], pv[PER][QMAX];
  int at[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + NT * u;
    int r = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);  // e = r (r + 1) / 2 + p, p <= r
    r += (r + 1) * (r + 2) / 2 <= e;
    r -= r * (r + 1) / 2 > e;
    const int p = e - r * (r + 1) / 2;
    const bool ok = e < TRI && r < w;
    at[u] = ok ? r * WP + p : -1;
    const int i = ok ? j0 + r : 0, j = ok ? j0 + p : 0;
    v[u] = input_t<T>(io, n, bc, i, j);
    load_slices(pv[u], part, n, par, q, ok, i, p);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (at[u] >= 0) D[at[u]] = v[u] - slices_sum(pv[u]);
  cp_wait_all();
  __syncthreads();
  if (k > 0) {
    if (warp < 6)  // (0, 0), (0, 1), (1, 0) .. (1, 3)
      tile_terms(D, TP, TP, warp < 2 ? 0 : 1, warp < 2 ? warp : warp - 2, tid & 31);
    __syncthreads();
  }
}

// Step 1 for the own rows below the tile (warps 1 and 4; t < 64): their
// sums A, the same way (LO: their panel k - 1 entries, TP: the tile rows',
// from tile_sums; the two warps meet at named barrier 7).
template <typename T>
__device__ __forceinline__ void row_sums(const Io& io, int n, int bc, const double* L,
                                         const double* y, double* part, int q, int par, int k,
                                         int j0, int w, int g, int ra, int nb, int Gv, double* sm,
                                         int t) {
  constexpr int NTB = 64, PER = (RMAX * W + NTB - 1) / NTB;
  double* A = sm + SM_A;
  double* LO = sm + SM_LO;
  double* TP = sm + SM_TP;
  if (k > 0 && nb > 0) copy_panel(LO, L, y, n, g + ra * Gv, Gv, nb, j0, t, NTB);
  cp_commit();
  constexpr int BATCH = 4;  // elements whose loads are in flight together
  for (int u0 = 0; u0 < PER; u0 += BATCH) {
    double v[BATCH], pv[BATCH][QMAX];
    int at[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = t + NTB * (u0 + u), r = e / W, p = e % W;
      const bool ok = r < nb && p < w;
      at[u] = ok ? r * WP + p : -1;
      const int i = ok ? g + (ra + r) * Gv : 0, j = ok ? j0 + p : 0;
      v[u] = input_t<T>(io, n, bc, i, j);
      load_slices(pv[u], part, n, par, q, ok, i, p);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (at[u] >= 0) A[at[u]] = v[u] - slices_sum(pv[u]);
  }
  cp_wait_all();
  bar_sync(7, NTB);
  if (k > 0) {
    for (int T = t >> 5; T < 4 * ((nb + 15) / 16); T += 2)
      tile_terms(A, LO, TP, T / 4, T % 4, t & 31);
    bar_sync(7, NTB);
  }
}

// One unit of the next panel's products (the bulk warps): a row block's rows
// (from r0, nr <= 32 of them, MT 16-row tiles) against the next tile's rows
// over one slice [c0, c1) of the finished columns, staged MC columns at a
// time (NSTAGE chunks in the ring); each warp takes every NBULK-th 8-column
// step of a chunk, and the warps' sums meet in shared memory (in warp order)
// before they go to the workspace as slice s.
struct Unit {
  int j1, w1;   // the next panel's first column and width
  int r0, nr;   // the row block
  int s, c0, c1;
  int par;      // the parity of the step that reads the sums
};

template <int MT>
__device__ __forceinline__ void unit_products(const Unit& u, int n, double* L, double* y,
                                              double* part, double* ST,
                                              unsigned long long* bars, unsigned& phases, int bw,
                                              int lane) {
  const int bt = bw * 32 + lane;
  const bool even = (n & 1) == 0;  // every row starts 16-byte aligned
  // Stage columns [m0, m0 + mc) of the tile rows (0 .. W - 1) and the row
  // block's (W ..) into buffer buf: with n even (every row 16-byte
  // aligned) one bulk copy a row, issued by warp 0's lanes, the buffer's
  // mbarrier expecting the bytes; else plain loads, a warp a row.
  auto stage = [&](int buf, int m0) {
    double* sb = ST + buf * STAGE;
    const int mc = min(MC, u.c1 - m0), rows = W + u.nr;
    if (even) {
      if (bw != 0) return;
      if (lane == 0) mbar_expect(bars + buf, (u.w1 + u.nr) * mc * 8);
      __syncwarp();
      for (int row = lane; row < rows; row += 32) {
        if (row < W && row >= u.w1) continue;
        const double* src = lrow(L, y, n, row < W ? u.j1 + row : u.r0 + row - W) + m0;
        bulk_copy(sb + row * SP, src, mc * 8, bars + buf);
      }
    } else {
      for (int row = bw; row < rows; row += NBULK) {
        if (row < W && row >= u.w1) continue;
        const double* src = lrow(L, y, n, row < W ? u.j1 + row : u.r0 + row - W) + m0;
        for (int c = lane; c < mc; c += 32) sb[row * SP + c] = __ldcg(src + c);
      }
    }
  };
  double acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
  const int chunks = (u.c1 - u.c0 + MC - 1) / MC;
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c)
    if (c < chunks) stage(c, u.c0 + c * MC);
  for (int c = 0; c < chunks; ++c) {
    // Chunk c is in (its buffer's barrier phase, or the plain loads and the
    // barrier below); the barrier also retires every warp's reads of chunk
    // c - 1, whose buffer then takes chunk c + NSTAGE - 1.
    const int buf = c % NSTAGE;
    if (even) {
      mbar_wait(bars + buf, (phases >> buf) & 1u);
      phases ^= 1u << buf;
    }
    bulk_sync();
    if (c + NSTAGE - 1 < chunks) stage((c + NSTAGE - 1) % NSTAGE, u.c0 + (c + NSTAGE - 1) * MC);
    const double* sb = ST + buf * STAGE;
    const int steps = min(MC, u.c1 - u.c0 - c * MC) / 8;
    for (int ks = bw; ks < steps; ks += NBULK) {
      double bf[4][2], af[MT][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) frag_b(bf[nt], sb, SP, 8 * nt, 8 * ks, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) frag_a(af[mt], sb, SP, W + 16 * mt, 8 * ks, lane, 1.0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  bulk_sync();  // every warp's last chunk read
  double* PART = ST;  // [NBULK][RMAX][WP], over the staging
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = mt * 16 + (lane >> 2), col = nt * 8 + 2 * (lane & 3);
      double* o = PART + (bw * RMAX + row) * WP + col;
      o[0] = acc[mt][nt][0];
      o[1] = acc[mt][nt][1];
      o[8 * WP] = acc[mt][nt][2];
      o[8 * WP + 1] = acc[mt][nt][3];
    }
  bulk_sync();
  for (int e = bt; e < u.nr * W; e += NBULK * 32) {
    const int tr = e / W, p = e % W;
    if (p >= u.w1) continue;
    double v = 0.0;
#pragma unroll
    for (int q = 0; q < NBULK; ++q) v += PART[(q * RMAX + tr) * WP + p];
    __stcg(part_at(part, n, u.par, u.s, u.r0 + tr, p), v);
  }
  bulk_sync();  // the staging is free again
}

// Block b's units of the products for panel k + 1 (row block rb's slice s is
// unit rb q + s, and unit v goes to block v mod G).
__device__ __forceinline__ void panel_products(int n, int k, int j0, int G, double* L, double* y,
                                               double* part, double* ST, unsigned long long* bars,
                                               unsigned& phases, int bw, int lane) {
  Unit u;
  u.j1 = j0 + W;
  u.w1 = min(W, n - u.j1);
  u.par = (k + 1) & 1;
  const int q = slices_of(n, u.j1, G), units = (n + 1 - u.j1 + W - 1) / W * q;
  for (int v = blockIdx.x; v < units; v += G) {
    const int rb = v / q;
    u.s = v % q;
    u.r0 = u.j1 + rb * W;
    u.nr = min(W, n + 1 - u.r0);
    u.c0 = j0 / 8 * u.s / q * 8;  // 8-column steps
    u.c1 = j0 / 8 * (u.s + 1) / q * 8;
    if (u.nr > 16)
      unit_products<2>(u, n, L, y, part, ST, bars, phases, bw, lane);
    else
      unit_products<1>(u, n, L, y, part, ST, bars, phases, bw, lane);
  }
}

#ifdef SFM_CHOL_STAMPS
#define STAMP(...) __VA_ARGS__
#else
#define STAMP(...)
#endif

__global__ void __launch_bounds__(NT, 1)
cholesky_kernel(Io io, int n, int bc, double* L, double* y, double* __restrict__ part,
                double* __restrict__ xs, int Gv) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double sm[];
  double* D = sm + SM_D;
  double* LT = sm + SM_LT;
  double* LO = sm + SM_LO;
  double* A = sm + SM_A;
  double* R = sm + SM_R;
  double* ST = sm + SM_ST;
  int* bad_flag = reinterpret_cast<int*>(sm + SM_END);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm + SM_END + 2);
  unsigned phases = 0;  // the bulk warps' view of each staging buffer's barrier phase
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int K = (n + W - 1) / W;
  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  STAMP(const long long c_start = clock64(); unsigned long long g_start;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));)
  if (tid == 0) *bad_flag = 0;
  for (int e = b * NT + tid; e < n; e += G * NT)  // read after the last grid barrier
    xs[e] = __longlong_as_double(static_cast<long long>(XS_UNSET));

  for (int k = 0; k < K; ++k) {
    const int j0 = k * W, w = min(W, n - j0);
    STAMP(const long long t0 = clock64();)
    if (k > 0) grid.sync();
    STAMP(const long long t1 = clock64(); long long tl = t1, a1 = 0, a2 = 0, a3 = 0, a4 = 0,
          a6 = 0, a7 = 0;)
    if (b == 0 && k > 0) write_tile(L, n, j0 - W, W, LT);
    const int par = k & 1;
    const int q = k >= 2 ? slices_of(n, j0, G) : 0;  // products in the workspace from panel 2 on

    // The block's row groups, one after the other (one group while Gv = G).
    for (int g = b; g < Gv; g += G) {
      const bool first = g == b;
      const int nrow = g <= n ? (n - g) / Gv + 1 : 0;  // the group's rows, the rhs row included
      const int ra = first_row(j0 + w, g, Gv);         // its rows below this panel's tile
      const int nb = max(nrow - ra, 0);
      // 1. The tile's sums (every thread, in the first group).
      if (first) {
        if (io.f32)
          tile_sums<float>(io, n, bc, L, y, part, q, par, k, j0, w, sm);
        else
          tile_sums<double>(io, n, bc, L, y, part, q, par, k, j0, w, sm);
      }
      STAMP(if (tid == 0) { const long long t = clock64(); a1 += t - tl; tl = t; })
      const int bw = bulk_index(warp);
      if (warp == 0) {
        // 2. Factor the tile, handing each sub-panel to warp 1.
        if (first) factor_tile(D, LT, R, w, lane, bad_flag, true);
        STAMP(if (lane == 0) { const long long t = clock64(); a2 += t - tl; tl = t; })
      } else if (warp == 1 || warp == 4) {
        // 1. The own rows' sums (warps 1 and 4); 2. warp 1 solves those rows
        // below the tile, a lane a row, each sub-panel as warp 0 hands it
        // over, and writes them.
        STAMP(const long long s0 = clock64();)
        if (io.f32)
          row_sums<float>(io, n, bc, L, y, part, q, par, k, j0, w, g, ra, nb, Gv, sm,
                          warp == 1 ? lane : 32 + lane);
        else
          row_sums<double>(io, n, bc, L, y, part, q, par, k, j0, w, g, ra, nb, Gv, sm,
                           warp == 1 ? lane : 32 + lane);
        STAMP(if (warp == 1) a7 += clock64() - s0;)
        if (warp == 1) {
          double a[W];
          const bool has = lane < nb;
#pragma unroll
          for (int p = 0; p < W; ++p) a[p] = has && p < w ? A[lane * WP + p] : 0.0;
          if (first) bar_sync(2, 64);
          solve_cols<0, 8>(a, LT, R);
          if (first) bar_sync(3, 64);
          solve_cols<8, 16>(a, LT, R);
          if (first) bar_sync(4, 64);
          solve_cols<16, 24>(a, LT, R);
          if (first) bar_sync(5, 64);
          solve_cols<24, 32>(a, LT, R);
          if (has)
#pragma unroll
            for (int p = 0; p < W; ++p) LO[lane * FP + p] = a[p];
          __syncwarp();
          for (int rr = 0; rr < nb; ++rr)
            if (lane < w) lrow(L, y, n, g + (ra + rr) * Gv)[j0 + lane] = LO[rr * FP + lane];
          STAMP(a3 += clock64() - s0;)
        }
      } else if (bw >= 0) {
        // 3. (in the first group) the block's units of the next panel's
        // products, once the tile's sums are in.
        STAMP(const long long s1 = clock64();)
        if (first && k + 1 < K && j0 > 0)
          panel_products(n, k, j0, G, L, y, part, ST, bars, phases, bw, lane);
        STAMP(a4 += clock64() - s1;)
      }
      __syncthreads();
      STAMP(if (tid == 0) { const long long t = clock64(); a6 += t - tl; tl = t; })
    }
    STAMP({
      unsigned long long* s = g_stamps + ((size_t)b * K + k) * 8;
      if (tid == 0) {
        s[0] = t1 - t0; s[1] = a1; s[2] = a2; s[5] = clock64() - t0; s[6] = a6;
      }
      if (tid == 32) s[3] = a3;
      if (tid == 32) s[7] = a7;
      if (tid == 64) s[4] = a4;
    })
  }
  STAMP(const long long bs0 = clock64();)
  grid.sync();
  STAMP(const long long bs1 = clock64();)

  // Back-substitution, L^T x = y, over the grid: block b takes panels
  // K - 1 - b, K - 1 - b - G, ..., each once every later panel's x is out.
  // Split so that the hand-off of x_{k+1}, which every panel waits for, is a
  // 32 x 32 product: x_k = u - M x_{k+1}, u = L_kk^-T (y_k - sum over j > k + 1
  // of L_jk^T x_j) and M = L_kk^-T L_{k+1,k}^T, both formed while x_{k+1} is
  // on its way.
  if (b == 0) write_tile(L, n, (K - 1) * W, n - (K - 1) * W, LT);
  __syncthreads();
  const bool bad = *bad_flag != 0;
  double* Ls = LT;  // the panel's tile, Ls[t][p] = L[j0 + t][j0 + p] below the diagonal
  double* RI = R;   // 1 / L[t][t]
  double* PZ = D;   // [NWARP][W] each warp's terms
  double* MS = sm + SM_TP;  // MS[t][p] = M[p][t]
  for (int k = K - 1 - b; k >= 0; k -= G) {
    const int j0 = k * W, w = min(W, n - j0);
    const int i1 = j0 + W, w1 = k + 1 < K ? min(W, n - i1) : 0;  // the next panel
    if (bad) {
      for (int j = tid; j < w; j += NT) store_x(io, j0 + j, NAN);
      continue;
    }
    for (int e = tid; e < W * W; e += NT) {
      const int t = e / W, p = e % W;
      Ls[t * LTP + p] = (p < t && t < w) ? __ldcg(L + (size_t)(j0 + t) * n + j0 + p) : 0.0;
    }
    if (tid < W) RI[tid] = tid < w ? 1.0 / __ldcg(L + (size_t)(j0 + tid) * n + j0 + tid) : 1.0;
    const double yk = warp == 0 && lane < w ? __ldcg(y + j0 + lane) : 0.0;
    double ln[W];  // warp 1, lane t: L_{k+1,k}'s row t, the right-hand side of M's column t
    if (warp == 1)
#pragma unroll
      for (int p = 0; p < W; ++p)
        ln[p] = lane < w1 && p < w ? __ldcg(L + (size_t)(i1 + lane) * n + j0 + p) : 0.0;
    // Warp v: the panels j > k + 1 with j = K - 1 - v (mod 8), from the last;
    // the L_jk block (lane p: column j0 + p) is loaded before x_j is polled.
    double zw = 0.0;
    const int cl = j0 + min(lane, w - 1);
    for (int j = K - 1 - warp; j > k + 1; j -= NWARP) {
      const int i0 = j * W, wj = min(W, n - i0);
      double lv[W];
#pragma unroll
      for (int t = 0; t < W; ++t) lv[t] = __ldcg(L + (size_t)(i0 + min(t, wj - 1)) * n + cl);
      const double xv = lane < wj ? poll_x(xs + i0 + lane) : 0.0;
#pragma unroll
      for (int t = 0; t < W; ++t) zw = fma(lv[t], __shfl_sync(FULL, xv, t), zw);
    }
    PZ[warp * W + lane] = zw;
    __syncthreads();
    double u = 0.0;
    if (warp == 0) {  // u, every lane the whole triangle, each keeping its entry
      double s = 0.0;
#pragma unroll
      for (int v = 0; v < NWARP; ++v) s += PZ[v * W + lane];
      const double z = yk - s;
      double zz[W];
#pragma unroll
      for (int p = 0; p < W; ++p) zz[p] = __shfl_sync(FULL, z, p);
      solve_triangle<W - 1>(zz, Ls, RI, lane, u);
    } else if (warp == 1 && w1 > 0) {  // M, a lane a column
      solve_columns<W - 1>(ln, Ls, RI);
#pragma unroll
      for (int p = 0; p < W; ++p) MS[lane * FP + p] = ln[p];
    }
    __syncthreads();
    if (warp == 0) {
      double s = 0.0;
      if (w1 > 0) {
        const double xv = lane < w1 ? poll_x(xs + i1 + lane) : 0.0;
#pragma unroll
        for (int t = 0; t < W; ++t) s = fma(MS[t * FP + lane], __shfl_sync(FULL, xv, t), s);
      }
      if (lane < w) {
        put_x(xs + j0 + lane, u - s);
        store_x(io, j0 + lane, u - s);
      }
    }
    __syncthreads();
  }
  STAMP(if (tid == 0) {
    unsigned long long g_end;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end));
    unsigned long long* e = g_stamps + (size_t)G * K * 8 + 4 * b;
    e[0] = bs1 - bs0; e[1] = clock64() - bs1; e[2] = clock64() - c_start; e[3] = g_end - g_start;
  })
}

int schur_cholesky_solve(int f32, const void* S, const void* rhs_c, const void* rhs_k, int n,
                         int bc, double eps, void* x, void* L, void* y, void* part, void* xs,
                         cudaStream_t st) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  static int grid_of_device[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cholesky_kernel, NT, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    grid_of_device[dev] = sms * per_sm;
  }
  int grid = min(grid_of_device[dev], n + 1);
  int groups = max(grid, (n + RMAX) / RMAX);  // at most RMAX rows a group
  Io io{S, rhs_c, rhs_k, x, eps, f32};
  double* Lp = static_cast<double*>(L);
  double* yp = static_cast<double*>(y);
  double* pp = static_cast<double*>(part);
  double* xp = static_cast<double*>(xs);
  void* args[] = {&io, &n, &bc, &Lp, &yp, &pp, &xp, &groups};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cholesky_kernel), dim3(grid),
                                  dim3(NT), args, SMEM_BYTES, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Once, when the library loads: the kernel may take its dynamic shared
// memory (~193 KB, above the default 48 KB).
SFM_API int sfm_schur_cholesky_setup(void* /*stream*/) {
  return static_cast<int>(cudaFuncSetAttribute(
      cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

// S: n x n (T); rhs_c: bc values, rhs_k: n - bc; x: n (T); L: n x n doubles
// for the factor and y: n doubles (in the double route S and x themselves:
// the factor overwrites S); part: 2 x 8 x (n + 1) x 32 doubles, the next
// panel's partial sums; xs: n doubles, x handed between blocks (set by the
// kernel itself before it is read).
SFM_API int sfm_schur_cholesky_solve(const void* S, const void* rhs_c, const void* rhs_k, int n,
                                     int bc, double eps, void* x, void* L, void* y, void* part,
                                     void* xs, void* stream) {
  return schur_cholesky_solve(1, S, rhs_c, rhs_k, n, bc, eps, x, L, y, part, xs,
                              static_cast<cudaStream_t>(stream));
}

SFM_API int sfm_schur_cholesky_solve_f64(const void* S, const void* rhs_c, const void* rhs_k,
                                         int n, int bc, double eps, void* x, void* L, void* y,
                                         void* part, void* xs, void* stream) {
  return schur_cholesky_solve(0, S, rhs_c, rhs_k, n, bc, eps, x, L, y, part, xs,
                              static_cast<cudaStream_t>(stream));
}

#ifdef SFM_CHOL_STAMPS
SFM_API int sfm_chol_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
#endif
