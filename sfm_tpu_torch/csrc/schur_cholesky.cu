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
// types, every dot product summed in double, and only x is rounded to T, once:
// in the float route x is then (nearly) the correctly rounded solution of the
// float S, whatever the blocking or the order of the sums, so the plain twin
// (ba/schur.py::dense_solve_plain, the same panels and rules) gives the same
// bits but where the two solutions straddle a rounding boundary. No TF32, no
// bf16. Below a pivot d a column's entries are a * rsqrt(d); the stored
// pivot is sqrt(d), which the back-substitution divides by.
//
// Storage: in the double route the factor overwrites S's lower triangle and
// y lives in x (schur_matrix_cuda makes a fresh S every call, and no caller
// reads S after the solve); in the float route they go to the wrapper's
// double workspace (L: n x n, y: n) and S is only read.
//
// Design: one persistent cooperative launch, a block an SM, all resident
// (cudaLaunchCooperativeKernel, the grid G from the occupancy calculator); one
// compiled body for both types (T only at the input and at x, a run-time
// flag: two instantiations allocate their registers apart, and one of them
// ran slower),
// left-looking over panels of W = 32 columns, one grid barrier a panel. Row i
// of the augmented matrix [S; rhs^T] belongs to row group i mod Gv, and row
// group v to block v mod G; row n is the right-hand side, so the forward
// substitution L y = rhs rides along as one more row (its entries go to y).
// Gv = G while no group holds more than RMAX rows (n < G RMAX: 3,167 on 132
// SMs); past that Gv = ceil((n + 1) / RMAX), a block runs its groups one
// after the other in each step, and a group's sums and panel entries wait
// in the wrapper's workspace between steps (the only difference: the sums
// and their order are the same for any Gv). Panel k's step, after its
// barrier:
//  1. every block loads the diagonal tile's sums over the panels before k - 1
//     (double, written by the tile rows' owners in step k - 1 to dbuf) and
//     the tile rows' entries of panel k - 1, and subtracts that panel's terms
//     (a 2 x 2 block of the tile a thread); the own rows below the tile (a
//     row group's at a time) do the same to the sums they keep in shared
//     memory;
//  2. warp 0 factors the 32 x 32 tile, redundantly in every block: a lane a
//     row in registers, right-looking in sub-panels of 8 columns (shuffles
//     inside a sub-panel, a rank-8 update from shared memory after it), no
//     branch in the pivot chain; then it solves the block's own rows below
//     the tile against it, a lane a row, side by side (the tile's columns are
//     shared-memory broadcasts), and writes them;
//  3. meanwhile warps 1-7 sum the next panel's dot products for those rows
//     over every finished panel: the next tile's rows and the own rows staged
//     a 128-column chunk at a time in shared memory as double, the next
//     chunk's loads in flight during a chunk's products.
// After the last panel, one more barrier; then block 0 back-substitutes
// L^T x = y panel by panel from the last: warp 0 solves the panel's triangle
// (every lane all of it, from broadcasts), warps 1-7 take the panel before
// it out of the rest of z (in shared memory up to n = Z_MAX, 5,376, past
// that in the workspace).
// What another block wrote is read through L2 (__ldcg): L1 is not coherent
// across SMs. Block 0 writes each diagonal tile of L a step late, once every
// block has read S's first tile. Deterministic: every sum in a fixed order,
// no atomics; it synchronises nothing on the host and allocates nothing
// (dbuf, 2 x 32 x 32 doubles, the row groups' state, z and the float route's
// factor are the wrapper's).
//
// What bounds it on the H100: the operations, n^3 / 3 + 2 n^2 (0.25 GFLOP at
// n = 904) at 67 TFLOP/s (float32's rate, and float64's on the tensor cores,
// where a Cholesky's rank-k products can run), ~4 us; the bytes, S read and
// x written once (3.3 MB at n = 904), ~1 us. What holds it back is the chain:
// n / 32 grid barriers, each panel's pivot chain of 32 columns (a shuffle,
// a double rsqrt and two FMAs a column) and its rows' 32-step
// substitution, and the back-substitution's n steps on one SM;
// past n ~ 1,000 the next panel's dot products, every block staging the same
// next-tile rows from L2 a chunk at a time, take longer than the chain.
#include <cooperative_groups.h>

#include "sfm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int W = 32;                 // panel width: a warp's lanes
constexpr int WP = W + 1;             // a padded tile row in shared memory
constexpr int LTP = W + 2;            // a row read as 16-byte pairs (LT, the solve's tile)
constexpr int NT = 256;               // threads a block
constexpr int NWARP = NT / 32;
constexpr int NBULK = NWARP - 1;      // warps 1-7: the next panel's dot products
constexpr int RMAX = 24;              // rows a row group holds at most (the rhs row included)
static_assert(RMAX <= 32, "the row solve takes a lane a row");
constexpr int MC = 128;               // columns a staged chunk
constexpr int LPR = MC / 32;          // a lane's loads a staged row
constexpr int TT_ROWS = (W + NBULK - 1) / NBULK;     // next-tile rows a bulk warp stages
constexpr int RO_ROWS = (RMAX + NBULK - 1) / NBULK;  // own rows a bulk warp stages
constexpr int TRI2 = (W / 2) * (W / 2 + 1) / 2;    // 2 x 2 blocks of a tile's lower triangle
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in doubles.
constexpr int SM_D = 0;                      // [W][WP] the diagonal tile's sums
constexpr int SM_LT = SM_D + W * WP;         // [W][LTP] LT[t][p] = L[j0 + p][j0 + t]
constexpr int SM_TP = SM_LT + W * LTP;       // [W][WP] TP[q][m] = L[j0 + q][j0 - W + m]
constexpr int SM_R = SM_TP + W * WP;         // [2][W] rsqrt of the pivots; two panels' x (back-sub.)
constexpr int SM_A = SM_R + 2 * W;           // [2][RMAX][W] own rows' sums: this panel, next
constexpr int SM_LO = SM_A + 2 * RMAX * W;   // [RMAX][W] own rows' entries of this panel
constexpr int SM_TT = SM_LO + RMAX * W;      // [MC][WP] the next tile's rows, a chunk
constexpr int SM_RO = SM_TT + MC * WP;       // [RMAX][MC] own rows, a chunk
constexpr int SM_PART = SM_RO + RMAX * MC;   // [NBULK][RMAX][W] partials; z at the end
constexpr int Z_MAX = NBULK * RMAX * W;      // the most n z holds in shared memory
constexpr int SM_END = SM_PART + Z_MAX;
constexpr int GROUP_STATE = 3 * RMAX * W;    // a row group's sums (two panels) and entries
constexpr int SMEM_BYTES = SM_END * 8 + 16;  // + the failure flag

__device__ __forceinline__ void bulk_sync() {  // warps 1-7 only
  asm volatile("bar.sync 1, %0;" ::"n"(NT - 32) : "memory");
}

// The first own row r (row b + r G) at or past row lo.
__device__ __forceinline__ int first_row(int lo, int b, int G) {
  return lo <= b ? 0 : (lo - b + G - 1) / G;
}

// Row i of the factor's storage (double): L's row, or y for the rhs row.
__device__ __forceinline__ double* lrow(double* L, double* y, int n, int i) {
  return i < n ? L + (size_t)i * n : y;
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

template <typename T>
__device__ __forceinline__ double input_t(const Io& io, int n, int bc, int i, int j) {
  if (i == n) {
    const T* r = static_cast<const T*>(j < bc ? io.rc : io.rk);
    return (double)__ldcg(r + (j < bc ? j : j - bc));
  }
  T v = __ldcg(static_cast<const T*>(io.S) + (size_t)i * n + j);
  if (i == j) v = v + (T)io.eps;  // S + eps I, the add in T
  return (double)v;
}

// Entry (i, j) of the augmented input [S + eps I; rhs^T].
__device__ __forceinline__ double input_of(const Io& io, int n, int bc, int i, int j) {
  return io.f32 ? input_t<float>(io, n, bc, i, j) : input_t<double>(io, n, bc, i, j);
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
// and R (rsqrt of each pivot); lane q holds row q in
// registers. Right-looking in sub-panels of SUB columns: column t's entries
// reach the lanes by shuffles for the rest of its own sub-panel, and the
// later sub-panels take a finished one as a rank-SUB update read from LT (16
// bytes a load): the shuffles a tile, which bound the chain, drop from ~500
// to ~110 a lane. Every entry still takes its terms in column order. A
// ragged tile is padded with unit rows, so all 32 steps run without a
// branch, and the padding touches no real entry. The pivot d waits in LT's
// diagonal until the end, when each lane takes its own sqrt(d).
constexpr int SUB = 8;

template <int S0>
__device__ __forceinline__ void factor_sub(double (&a)[W], double& diag, bool& bad, double* LT,
                                           double* R, int w, int lane) {
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
  if constexpr (S0 + SUB < W) {
    __syncwarp();
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt) axpy_row<S0 + SUB, W>(a, ls[tt], LT + (S0 + tt) * LTP);
  }
}

__device__ __forceinline__ void factor_tile(const double* D, double* LT, double* R, int w,
                                            int lane, int* bad_flag) {
  double a[W];
#pragma unroll
  for (int p = 0; p < W; ++p) a[p] = (lane < w && p <= lane) ? D[lane * WP + p] : 0.0;
  double diag = lane < w ? D[lane * WP + lane] : 1.0;
  bool bad = false;
  factor_sub<0>(a, diag, bad, LT, R, w, lane);
  factor_sub<8>(a, diag, bad, LT, R, w, lane);
  factor_sub<16>(a, diag, bad, LT, R, w, lane);
  factor_sub<24>(a, diag, bad, LT, R, w, lane);
  __syncwarp();
  if (lane < w) LT[lane * LTP + lane] = sqrt(LT[lane * LTP + lane]);
  if (bad && lane == 0) *bad_flag = 1;
}

// An own row's substitution against the tile, steps T0.. (a lane a row):
// its entry t is a[t] r_t, then column t's terms leave the later entries.
template <int T0>
__device__ __forceinline__ void solve_row(double (&a)[W], const double* LT, const double* R,
                                          double* lo) {
  if constexpr (T0 < W) {
    const double l = a[T0] * R[T0];
    lo[T0] = l;
    axpy_row<T0 + 1, W>(a, l, LT + T0 * LTP);
    solve_row<T0 + 1>(a, LT, R, lo);
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

// A bulk warp's dot products over a staged chunk, for NB own rows (a
// compile-time count: a runtime one costs a predicated load and FMA for
// every possible row at every column).
template <int NB>
__device__ __forceinline__ void bulk_dots(const double* TT, const double* RO, int bw, int mc,
                                          int lane, double (&acc)[RMAX]) {
  for (int mm = bw; mm < mc; mm += NBULK) {
    const double t = TT[mm * WP + lane];
#pragma unroll
    for (int rr = 0; rr < NB; ++rr) acc[rr] = fma(RO[rr * MC + mm], t, acc[rr]);
  }
}

template <int NB = 1>
__device__ __forceinline__ void bulk_dots_of(int nb, const double* TT, const double* RO, int bw,
                                             int mc, int lane, double (&acc)[RMAX]) {
  if constexpr (NB < RMAX) {
    if (nb > NB) {
      bulk_dots_of<NB + 1>(nb, TT, RO, bw, mc, lane, acc);
      return;
    }
  }
  bulk_dots<NB>(TT, RO, bw, mc, lane, acc);
}

// Block 0: L's diagonal tile at row and column j0 (w x w) from LT into L.
__device__ __forceinline__ void write_tile(double* L, int n, int j0, int w, const double* LT) {
  for (int e = threadIdx.x; e < W * W; e += NT) {
    const int p = e / W, t = e % W;
    if (p < w && t <= p) L[(size_t)(j0 + p) * n + j0 + t] = LT[t * LTP + p];
  }
}

__global__ void __launch_bounds__(NT, 1)
cholesky_kernel(Io io, int n, int bc, double* L, double* y, double* __restrict__ dbuf,
                double* __restrict__ state, double* __restrict__ zg, int Gv) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double sm[];
  double* D = sm + SM_D;
  double* LT = sm + SM_LT;
  double* TP = sm + SM_TP;
  double* R = sm + SM_R;
  double* LO = sm + SM_LO;
  double* TT = sm + SM_TT;
  double* RO = sm + SM_RO;
  double* PART = sm + SM_PART;
  int* bad_flag = reinterpret_cast<int*>(sm + SM_END);
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool spill = Gv > G;  // row groups wait in the workspace between steps
  const int K = (n + W - 1) / W;
  if (tid == 0) *bad_flag = 0;
  int cur = 0;

  for (int k = 0; k < K; ++k) {
    const int j0 = k * W, w = min(W, n - j0);
    double* Acur = sm + SM_A + cur * RMAX * W;
    double* Anxt = sm + SM_A + (cur ^ 1) * RMAX * W;
    if (k > 0) grid.sync();

    // 1. The tile's sums and panel k - 1's terms.
    if (b == 0 && k > 0) write_tile(L, n, j0 - W, W, LT);
    // Every load is issued before any is used: addresses are clamped into
    // the matrix and the values masked afterwards, so no condition stands
    // between a load and the next.
    if (k == 0) {
      for (int e = tid; e < W * W; e += NT) {
        const int q = e / W, p = e % W;
        if (q < w && p <= q) D[q * WP + p] = input_of(io, n, bc, j0 + q, j0 + p);
      }
    } else {
      double dv[W * W / NT], tp[W * W / NT];
#pragma unroll
      for (int u = 0; u < W * W / NT; ++u) {
        const int e = tid + u * NT, q = min(e / W, w - 1), p = e % W;
        dv[u] = __ldcg(dbuf + (k & 1) * W * W + e);
        tp[u] = __ldcg(L + (size_t)(j0 + q) * n + j0 - W + p);
      }
#pragma unroll
      for (int u = 0; u < W * W / NT; ++u) {
        const int e = tid + u * NT, q = e / W, p = e % W;
        if (q < w && p <= q) D[q * WP + p] = dv[u];
        if (q < w) TP[q * WP + p] = tp[u];
      }
    }

    // The block's row groups, one after the other (one group while Gv = G).
    for (int g = b; g < Gv; g += G) {
      const bool first = g == b;
      const int nrow = g <= n ? (n - g) / Gv + 1 : 0;  // the group's rows, the rhs row included
      const int ra = first_row(j0 + w, g, Gv);         // its rows below this panel's tile
      double* gst = state + (size_t)g * GROUP_STATE;
      if (spill && k > 0) {  // the sums of this panel and the entries of the last
        for (int e = tid; e < RMAX * W; e += NT) {
          Acur[e] = __ldcg(gst + cur * RMAX * W + e);
          LO[e] = __ldcg(gst + 2 * RMAX * W + e);
        }
      }
      if (k == 0) {
        for (int e = tid; e < (nrow - ra) * W; e += NT) {
          const int r = ra + e / W, p = e % W;
          if (p < w) Acur[r * W + p] = input_of(io, n, bc, g + r * Gv, j0 + p);
        }
      }
      __syncthreads();

      // The next panel's dot products (warps 1-7, step 3): warp bw stages
      // next-tile rows bw, bw + 7, ... and own rows alike, a lane every 32nd
      // column (clamped into the chunk; masked when stored). The first chunk's
      // loads leave before the tile's sums below, and fly meanwhile.
      const bool bulk = warp > 0 && k + 1 < K && ra < nrow;
      const int bw = warp - 1, bt = tid - 32;
      const int j1 = j0 + W, w1 = min(W, n - j1);
      const int nb = nrow - ra;
      double tv[TT_ROWS][LPR], rv[RO_ROWS][LPR];
      auto load = [&](int m0) {
        const int mc = min(MC, j0 - m0);
#pragma unroll
        for (int u = 0; u < TT_ROWS; ++u) {
          const int p = bw + u * NBULK;
          if (p < w1) {
            const double* row = L + (size_t)(j1 + p) * n + m0;
#pragma unroll
            for (int v = 0; v < LPR; ++v) tv[u][v] = __ldcg(row + min(lane + 32 * v, mc - 1));
          }
        }
#pragma unroll
        for (int u = 0; u < RO_ROWS; ++u) {
          const int rr = bw + u * NBULK;
          if (rr < nb) {
            const double* row = lrow(L, y, n, g + (ra + rr) * Gv) + m0;
#pragma unroll
            for (int v = 0; v < LPR; ++v) rv[u][v] = __ldcg(row + min(lane + 32 * v, mc - 1));
          }
        }
      };
      if (bulk && j0 > 0) load(0);

      if (k > 0) {
        if (tid < TRI2) {  // the tile's sums: a 2 x 2 block of the lower triangle a thread
          if (first) {
            int bq = (int)((sqrtf(8.f * tid + 1.f) - 1.f) * 0.5f);
            bq += (bq + 1) * (bq + 2) / 2 <= tid;
            bq -= bq * (bq + 1) / 2 > tid;
            const int q0 = 2 * bq, p0 = 2 * (tid - bq * (bq + 1) / 2);
            double s00 = 0.0, s01 = 0.0, s10 = 0.0, s11 = 0.0;
#pragma unroll 8
            for (int m = 0; m < W; ++m) {
              const double a0 = TP[q0 * WP + m], a1 = TP[(q0 + 1) * WP + m];
              const double b0 = TP[p0 * WP + m], b1 = TP[(p0 + 1) * WP + m];
              s00 = fma(a0, b0, s00);
              s01 = fma(a0, b1, s01);
              s10 = fma(a1, b0, s10);
              s11 = fma(a1, b1, s11);
            }
            if (q0 < w) {
              D[q0 * WP + p0] -= s00;
              if (p0 < q0) D[q0 * WP + p0 + 1] -= s01;
            }
            if (q0 + 1 < w) {
              D[(q0 + 1) * WP + p0] -= s10;
              D[(q0 + 1) * WP + p0 + 1] -= s11;
            }
          }
        } else {  // the own rows' sums, on the other threads
          for (int e = tid - TRI2; e < (nrow - ra) * W; e += NT - TRI2) {
            const int r = ra + e / W, p = e % W;
            if (p < w) {
              double s = 0.0;
#pragma unroll 8
              for (int m = 0; m < W; ++m) s = fma(LO[r * W + m], TP[p * WP + m], s);
              Acur[r * W + p] -= s;
            }
          }
        }
      }
      __syncthreads();

      // 2. Warp 0 factors the tile, then solves the own rows below it; 3. warps
      // 1-7 sum the next panel's dot products over the finished panels (m < j0)
      // for the own rows past this tile.
      if (warp == 0) {
        if (first) factor_tile(D, LT, R, w, lane, bad_flag);
        __syncwarp();
        // The own rows below the tile, a lane a row (at most RMAX <= 32):
        // column t's entries are broadcasts of LT's row t, so the lanes run the
        // substitution side by side, with no shuffle.
        const int r = ra + lane;
        if (r < nrow) {
          double a[W];
#pragma unroll
          for (int p = 0; p < W; ++p) a[p] = p < w ? Acur[r * W + p] : 0.0;
          solve_row<0>(a, LT, R, LO + r * W);
        }
        __syncwarp();
        for (int rr = ra; rr < nrow; ++rr)
          if (lane < w) lrow(L, y, n, g + rr * Gv)[j0 + lane] = LO[rr * W + lane];
      } else if (bulk) {
        double acc[RMAX];
#pragma unroll
        for (int rr = 0; rr < RMAX; ++rr) acc[rr] = 0.0;
        for (int m0 = 0; m0 < j0; m0 += MC) {
          const int mc = min(MC, j0 - m0);
#pragma unroll
          for (int u = 0; u < TT_ROWS; ++u) {
            const int p = bw + u * NBULK;
            if (p < W)
#pragma unroll
              for (int v = 0; v < LPR; ++v)
                TT[(lane + 32 * v) * WP + p] = p < w1 ? tv[u][v] : 0.0;
          }
#pragma unroll
          for (int u = 0; u < RO_ROWS; ++u) {
            const int rr = bw + u * NBULK;
            if (rr < nb)
#pragma unroll
              for (int v = 0; v < LPR; ++v) RO[rr * MC + lane + 32 * v] = rv[u][v];
          }
          bulk_sync();
          if (m0 + MC < j0) load(m0 + MC);  // the next chunk's loads in flight
          bulk_dots_of(nb, TT, RO, bw, mc, lane, acc);
          bulk_sync();
        }
#pragma unroll
        for (int rr = 0; rr < RMAX; ++rr)
          if (rr < nb) PART[(bw * RMAX + rr) * W + lane] = acc[rr];
        bulk_sync();
        for (int e = bt; e < nb * W; e += NT - 32) {
          const int rr = e / W, p = e % W, r = ra + rr, i = g + r * Gv;
          if (p >= w1) continue;
          double s = 0.0;
          for (int u = 0; u < NBULK; ++u) s += PART[(u * RMAX + rr) * W + p];
          const double v = input_of(io, n, bc, i, j1 + p) - s;
          const int q = i - j1;
          if (q < w1) {
            if (p <= q) dbuf[((k + 1) & 1) * W * W + q * W + p] = v;  // the next tile's row
          } else {
            Anxt[r * W + p] = v;
          }
        }
      }
      __syncthreads();
      if (spill) {  // the next panel's sums and this panel's entries
        for (int e = tid; e < RMAX * W; e += NT) {
          __stcg(gst + (cur ^ 1) * RMAX * W + e, Anxt[e]);
          __stcg(gst + 2 * RMAX * W + e, LO[e]);
        }
        __syncthreads();
      }
    }
    cur ^= 1;
  }
  grid.sync();
  if (b != 0) return;

  // Back-substitution, L^T x = y, in block 0. z: y less the solved panels'
  // terms (double); R holds two panels' x in turn.
  const int k_last = K - 1;
  write_tile(L, n, k_last * W, n - k_last * W, LT);
  __syncthreads();
  if (*bad_flag) {
    for (int j = tid; j < n; j += NT) store_x(io, j, NAN);
    return;
  }
  double* z = n <= Z_MAX ? PART : zg;
  for (int j = tid; j < n; j += NT) z[j] = __ldcg(y + j);
  __syncthreads();
  for (int k = k_last; k >= 0; --k) {
    const int j0 = k * W, w = min(W, n - j0);
    const int wn = k < k_last ? min(W, n - j0 - W) : 0;  // the panel after it
    double* xs = R + (k & 1) * W;                         // this panel's x
    const double* xp = R + ((k + 1) & 1) * W;             // the panel after's
    if (warp == 0) {
      // Lane p: its column of the tile (L[j0 + t][j0 + p]) to shared memory,
      // its z less the next panel's terms (L[j0 + W + t][j0 + p]), its inverse
      // pivot, every load issued first, clamped into the matrix; then every
      // lane solves the whole triangle from broadcasts (no shuffle on the
      // chain) and keeps its own x.
      double* Ls = TT;  // the tile, Ls[t][p] = L[j0 + t][j0 + p] below the diagonal
      double* ZR = TP;  // z and 1 / L[t][t] of the panel
      const int c = j0 + min(lane, w - 1);
      {
        double lc[W];
#pragma unroll
        for (int t = 0; t < W; ++t) lc[t] = __ldcg(L + (size_t)(j0 + min(t, w - 1)) * n + c);
#pragma unroll
        for (int t = 0; t < W; ++t) Ls[t * LTP + lane] = (lane < t && t < w) ? lc[t] : 0.0;
      }
      double zp = z[c];
      if (wn > 0) {
        double ln[W];
#pragma unroll
        for (int t = 0; t < W; ++t) ln[t] = __ldcg(L + (size_t)(j0 + W + min(t, wn - 1)) * n + c);
        double s = 0.0;
#pragma unroll
        for (int t = 0; t < W; ++t)
          if (t < wn) s = fma(ln[t], xp[t], s);
        zp -= s;
      }
      const double rb = 1.0 / __ldcg(L + (size_t)c * n + c);
      ZR[lane] = lane < w ? zp : 0.0;
      ZR[W + lane] = lane < w ? rb : 1.0;
      __syncwarp();
      double zz[W];
#pragma unroll
      for (int p = 0; p < W; ++p) zz[p] = ZR[p];
      double mine = 0.0;
      solve_triangle<W - 1>(zz, Ls, ZR + W, lane, mine);
      if (lane < w) {
        store_x(io, j0 + lane, mine);
        xs[lane] = mine;
      }
    } else if (wn > 0) {  // the panel after this one, from the rest of z: two
      // columns a thread at a time, their 2 x 32 loads in flight together
      for (int j = tid - 32; j < j0; j += 2 * (NT - 32)) {
        const int j2 = min(j + NT - 32, j0 - 1);
        double va[W], vb[W];
#pragma unroll
        for (int t = 0; t < W; ++t) {
          const double* row = L + (size_t)(j0 + W + min(t, wn - 1)) * n;
          va[t] = __ldcg(row + j);
          vb[t] = __ldcg(row + j2);
        }
        double sa = 0.0, sb = 0.0;
#pragma unroll
        for (int t = 0; t < W; ++t)
          if (t < wn) {
            sa = fma(va[t], xp[t], sa);
            sb = fma(vb[t], xp[t], sb);
          }
        z[j] -= sa;
        if (j + NT - 32 < j0) z[j + NT - 32] -= sb;
      }
    }
    __syncthreads();
  }
}

int schur_cholesky_solve(int f32, const void* S, const void* rhs_c, const void* rhs_k, int n,
                         int bc, double eps, void* x, void* L, void* y, void* dbuf, void* state,
                         void* z, cudaStream_t st) {
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
  double* db = static_cast<double*>(dbuf);
  double* stp = static_cast<double*>(state);
  double* zp = static_cast<double*>(z);
  void* args[] = {&io, &n, &bc, &Lp, &yp, &db, &stp, &zp, &groups};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cholesky_kernel), dim3(grid),
                                  dim3(NT), args, SMEM_BYTES, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Once, when the library loads: the kernel may take its dynamic shared
// memory (~146 KB, above the default 48 KB).
SFM_API int sfm_schur_cholesky_setup(void* /*stream*/) {
  return static_cast<int>(cudaFuncSetAttribute(
      cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

// S: n x n (T); rhs_c: bc values, rhs_k: n - bc; x: n (T); L: n x n doubles
// for the factor and y: n doubles (in the double route S and x themselves:
// the factor overwrites S); dbuf: 2 x 32 x 32 doubles of scratch; state:
// 3 x 24 x 32 doubles for each of ceil((n + 1) / 24) row groups; z: n
// doubles (state and z are read only past 3,167 rows and past n = 5,376).
SFM_API int sfm_schur_cholesky_solve(const void* S, const void* rhs_c, const void* rhs_k, int n,
                                     int bc, double eps, void* x, void* L, void* y, void* dbuf,
                                     void* state, void* z, void* stream) {
  return schur_cholesky_solve(1, S, rhs_c, rhs_k, n, bc, eps, x, L, y, dbuf, state, z,
                              static_cast<cudaStream_t>(stream));
}

SFM_API int sfm_schur_cholesky_solve_f64(const void* S, const void* rhs_c, const void* rhs_k,
                                         int n, int bc, double eps, void* x, void* L, void* y,
                                         void* dbuf, void* state, void* z, void* stream) {
  return schur_cholesky_solve(0, S, rhs_c, rhs_k, n, bc, eps, x, L, y, dbuf, state, z,
                              static_cast<cudaStream_t>(stream));
}
