// Kernel K2: F-RANSAC of a batch of pairs in one launch -- every hypothesis,
// its score, the winner, the winner's weighted rank-2 refit and the verify
// gates.
//
// Replaces sfm_tpu/estimators/fundamental.py::estimate_fundamental_ransac
// (:20): the vmapped epipolar.py::eight_point(..., enforce_rank2=False,
// null_iters=3, null_fallback=False) over the RANSAC samples, the vmapped
// symmetric_epipolar_distance over the (iters, N_score) error matrix and
// ransac.py::ransac_select, then the winner's consensus over all rows, the
// weighted eight_point refit (utils/linalg.py::smallest_eigvec with its
// fallback-shift tier, then the rank-2 SVD) and the final inliers; and the
// gates of sfm_tpu/matching/verify.py::verify_pair (:30). XLA ran these as
// chains of batched small matmuls, Cholesky column loops, an SVD and masked
// reductions, every intermediate (the 512 x 256 error matrix a pair among
// them) in device memory.
//
// Design. The first design ran three launches a chunk (a thread a hypothesis
// on 64 SMs; a block a pair for the scoring, whose threads walked two
// hypotheses each over the points one error at a time, 32 SMs; a block a pair
// for the refit). Its clock64 stamps (tests/ransac_stamps.py) put 123 of the
// chunk's ~155 us in the scoring walk and 13 of the refit's 23 in thread 0's
// solve. Here one launch does it all, and every operation and its order is
// the first design's, so every output keeps its bits:
//
// * A block of 256 threads is a tile of HT = 64 hypotheses of one pair
//   (grid: tiles x pairs, 256 blocks, two an SM, for a 32 x 512 chunk). It
//   stages the pair's rows in shared memory (and finds the last valid
//   scoring row: the walk skips invalid rows, as the first design did);
//   threads 0-63 solve a hypothesis each (the eight-point code of the first
//   design, verbatim) and store F once (the refit reads the winner's).
// * The walk: an error is a chain of two IEEE divisions and two square roots
//   whose slow-path branches keep the compiler from overlapping the errors of
//   one thread (a thread walking a hypothesis alone, 8 errors unrolled, took
//   ~170 ns an error). So 4 threads a hypothesis compute the errors of 32
//   points at a time into shared memory (double-buffered, one barrier a
//   chunk), 16 warps an SM, and thread j < 64 adds its hypothesis's errors in
//   the point order: each count / error-sum chain is the first design's.
// * ransac_select's rule (highest score, then lowest index) is a total order,
//   so the tiles' bests combine in any order: each tile's thread 0 writes its
//   best, a ticket in device memory finds the pair's last tile, and that block
//   picks the pair's winner and runs the first design's refit and gates
//   (fmat_refit_verify's body: 256 threads, the same block sums). Its solve
//   (the clamped Cholesky, 8 inverse-iteration steps, rank 2), thread 0's
//   chain of divisions there, runs in warp 0 with the independent divisions
//   spread over lanes (below).
//
// What bounds it on the H100: neither rate. Scoring ~45 FLOP per hypothesis
// and point (189 MFLOP a chunk: ~3 us at the f32 peak), the solves ~1.7 kFLOP
// a sample; the inputs and outputs are ~1.8 MB a chunk (~0.5 us). Its time is
// latency and issue: a thread's 9x9 factor and 3 inverse iterations, the
// walk's ~100 instructions an error on the issue slots, and the last tile's
// refit with warp 0's solve (its 144 dependent substitution divisions).
#include <climits>

#include "sfm_geom.cuh"

namespace {

constexpr int NT = 256;       // threads a block (the first design's refit block)
constexpr int HT = 64;        // hypotheses a tile
constexpr int Q = NT / HT;    // threads a hypothesis in the walk
constexpr int CH = 32;        // points a chunk of the walk
constexpr int MAXN = 1024;    // rows of a pair in shared memory

struct VerifyOut {
  float* Fs;
  int64_t* best;
  int64_t* count;
  float* F;
  uint8_t* inliers;
  float* errors;
  int* num_matches;
  int* num_inliers;
  float* inlier_ratio;
  float* mean_error;
  uint8_t* well_distributed;
  uint8_t* accept;
  uint8_t* ok;
};

struct Gates {
  float thr;
  int min_inliers;
  float min_ratio, max_err, min_spread;
};

// The first design's fmat_hypotheses of one sample: the 8 sampled rows,
// Hartley-normalized; A^T A + (1e-6 mean_eig + 1e-20) I by the clamped
// Cholesky; 3 inverse-iteration steps; F = T2^T Fn T1 of unit norm.
__device__ __forceinline__ void hypothesis(const float (*sp)[MAXN], const int64_t* idx, int N,
                                           float F[9]) {
  float p[4][8];  // x1, y1, x2, y2 of the sample
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t j = sfm_clamp_index(idx[k], N - 1);
    p[0][k] = sp[0][j];
    p[1][k] = sp[1][j];
    p[2][k] = sp[2][j];
    p[3][k] = sp[3][j];
  }
  float T[2][3];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* x = p[2 * m];
    float* y = p[2 * m + 1];
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sx += x[k];
      sy += y[k];
    }
    const float cx = sx / 8.f, cy = sy / 8.f;
    float md = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k] -= cx;
      y[k] -= cy;
      md += sqrtf(x[k] * x[k] + y[k] * y[k]);
    }
    const float s = 1.41421356237309515f / fmaxf(md / 8.f, 1e-12f);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x[k] *= s;
      y[k] *= s;
    }
    T[m][0] = s;
    T[m][1] = cx;
    T[m][2] = cy;
  }
  float A[45];
#pragma unroll
  for (int e = 0; e < 45; ++e) A[e] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sfm_add_design_row(p[0][k], p[1][k], p[2][k], p[3][k], 1.f, A);
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) tr += A[sfm_pk(i, i)];
  sfm_cholesky_clamped<9>(A, 1e-6f * (tr / 9.f) + 1e-20f, A);
  float f[9];
  sfm_inverse_iterate<9>(A, 3, f);
  sfm_denormalize(f, T[0], T[1], F);
}

// ---- The refit's solve by warp 0. The first design ran it in thread 0: the
// clamped Cholesky, 8 inverse-iteration steps, 12 squarings for rank 2 and
// the denormalization, ~370 IEEE divisions in one serial chain, whose
// slow-path branches keep even independent divisions from overlapping. Here
// every lane of warp 0 runs the same chain (the same operations, the same
// bits), except where a step divides several values by one divisor (a
// Cholesky column, a normalization, a squaring's scale, F's norm): there lane
// i divides entry i, once for all lanes, and a shuffle hands every lane the
// quotients. The substitutions (9 dependent divisions each) stay serial.

// sfm_cholesky_clamped<9>(A, shift, L) by a warp; L is not A.
__device__ __forceinline__ bool cholesky9_warp(const float* A, float shift, float* L, int lane) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc += L[sfm_pk(j, k)] * L[sfm_pk(j, k)];
    const float s = (A[sfm_pk(j, j)] + shift) - acc;
    bad |= s <= 0.f;
    const float d = sqrtf(fmaxf(s, 1e-30f));
    L[sfm_pk(j, j)] = d;
    if (j == 8) break;
    float num[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};   // A_ij - sum_k L_ik L_jk, i > j
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      float r = 0.f;
#pragma unroll
      for (int k = 0; k < j; ++k) r += L[sfm_pk(i, k)] * L[sfm_pk(j, k)];
      num[i - j - 1] = A[sfm_pk(i, j)] - r;
    }
    const float q = sfm_lane_pick<8>(num, 8 - j, lane) / d;
#pragma unroll
    for (int i = j + 1; i < 9; ++i) L[sfm_pk(i, j)] = __shfl_sync(SFM_FULL_MASK, q, i - j - 1);
  }
  return bad;
}

// sfm_inverse_iterate<9>(L, iters, x) by a warp.
__device__ __forceinline__ void inverse_iterate9_warp(const float* L, int iters, float* x,
                                                      int lane) {
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i] = 1.f + 1e-3f * (float)i;
  for (int it = 0; it < iters; ++it) {
    float y[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float s = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[sfm_pk(i, k)] * y[k];
      y[i] = s / L[sfm_pk(i, i)];
    }
#pragma unroll
    for (int i = 8; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < 9; ++k) s -= L[sfm_pk(k, i)] * x[k];
      x[i] = s / L[sfm_pk(i, i)];
    }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) n2 += x[i] * x[i];
    sfm_warp_divide<9>(x, fmaxf(sqrtf(n2), 1e-30f), lane);
  }
}

// sfm_rank2_project(f) by a warp.
__device__ __forceinline__ void rank2_project_warp(float* f, int lane) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = f[i] * f[j] + f[3 + i] * f[3 + j] + f[6 + i] * f[6 + j];
  float P[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float* a = M + ((j + 1) % 3) * 3;
    const float* b = M + ((j + 2) % 3) * 3;
    P[0 * 3 + j] = a[1] * b[2] - a[2] * b[1];
    P[1 * 3 + j] = a[2] * b[0] - a[0] * b[2];
    P[2 * 3 + j] = a[0] * b[1] - a[1] * b[0];
  }
  for (int k = 0; k < 12; ++k) {
    float Q[9], mx = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        Q[i * 3 + j] = P[i * 3] * P[j] + P[i * 3 + 1] * P[3 + j] + P[i * 3 + 2] * P[6 + j];
        mx = fmaxf(mx, fabsf(Q[i * 3 + j]));
      }
    mx = fmaxf(mx, 1e-30f);
    sfm_warp_divide<9>(Q, mx, lane);
#pragma unroll
    for (int e = 0; e < 9; ++e) P[e] = Q[e];
  }
  int jm = 0;
  float best = -1.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float n2 = P[j] * P[j] + P[3 + j] * P[3 + j] + P[6 + j] * P[6 + j];
    if (n2 > best) {
      best = n2;
      jm = j;
    }
  }
  const float nrm = fmaxf(sqrtf(best), 1e-30f);
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = jm == 0 ? P[i * 3] : (jm == 1 ? P[i * 3 + 1] : P[i * 3 + 2]);
  sfm_warp_divide<3>(v, nrm, lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fv = f[i * 3] * v[0] + f[i * 3 + 1] * v[1] + f[i * 3 + 2] * v[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) f[i * 3 + j] -= fv * v[j];
  }
}

// sfm_denormalize(fn, t1, t2, F) by a warp.
__device__ __forceinline__ void denormalize_warp(const float* fn, const float* t1,
                                                 const float* t2, float* F, int lane) {
  const float T1[9] = {t1[0], 0.f, -t1[0] * t1[1], 0.f, t1[0], -t1[0] * t1[2], 0.f, 0.f, 1.f};
  const float T2[9] = {t2[0], 0.f, -t2[0] * t2[1], 0.f, t2[0], -t2[0] * t2[2], 0.f, 0.f, 1.f};
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i * 3 + j] = fn[i * 3] * T1[j] + fn[i * 3 + 1] * T1[3 + j] + fn[i * 3 + 2] * T1[6 + j];
  float n2 = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      F[i * 3 + j] = T2[i] * M[j] + T2[3 + i] * M[3 + j] + T2[6 + i] * M[6 + j];
      n2 += F[i * 3 + j] * F[i * 3 + j];
    }
  sfm_warp_divide<9>(F, fmaxf(sqrtf(n2), 1e-12f), lane);
}

// sfm_eight_point_block<NT> of the rows (x1, y1, x2, y2, w) in shared memory,
// its solve by warp 0: the weighted Hartley normalization and A^T A as the
// first design's block sums (lane m of warp 0 adds A^T A's entry m over the
// warps), then smallest_eigvec (8 steps; the 1e-3 fallback shift when a pivot
// of the 1e-6 factor is nonpositive), rank 2 and the denormalization into F
// (shared, 9). Every thread must call it; F is ready when it returns.
__device__ void eight_point(const float (*sp)[MAXN], const float* w, int N, float (*red)[45],
                            float* sA, float* F) {
  const float* x1 = sp[0];
  const float* y1 = sp[1];
  const float* x2 = sp[2];
  const float* y2 = sp[3];
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sum w, w x1, w y1, w x2, w y2
  for (int n = threadIdx.x; n < N; n += NT) {
    const float wn = w[n];
    acc[0] += wn;
    acc[1] += x1[n] * wn;
    acc[2] += y1[n] * wn;
    acc[3] += x2[n] * wn;
    acc[4] += y2[n] * wn;
  }
  sfm_block_sum<NT, 5>(acc, reinterpret_cast<float(*)[5]>(&red[0][0]));
  const float wsum = fmaxf(acc[0], 1e-12f);
  const float c[4] = {acc[1] / wsum, acc[2] / wsum, acc[3] / wsum, acc[4] / wsum};

  float md[2] = {0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += NT) {
    const float dx1 = x1[n] - c[0], dy1 = y1[n] - c[1];
    const float dx2 = x2[n] - c[2], dy2 = y2[n] - c[3];
    md[0] += sqrtf(dx1 * dx1 + dy1 * dy1) * w[n];
    md[1] += sqrtf(dx2 * dx2 + dy2 * dy2) * w[n];
  }
  sfm_block_sum<NT, 2>(md, reinterpret_cast<float(*)[2]>(&red[0][0]));
  const float s1 = 1.41421356237309515f / fmaxf(md[0] / wsum, 1e-12f);
  const float s2 = 1.41421356237309515f / fmaxf(md[1] / wsum, 1e-12f);

  float A[45];
#pragma unroll
  for (int e = 0; e < 45; ++e) A[e] = 0.f;
  for (int n = threadIdx.x; n < N; n += NT) {
    if (w[n] == 0.f) continue;
    sfm_add_design_row((x1[n] - c[0]) * s1, (y1[n] - c[1]) * s1, (x2[n] - c[2]) * s2,
                       (y2[n] - c[3]) * s2, w[n], A);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < 45; ++m)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) A[m] += __shfl_xor_sync(SFM_FULL_MASK, A[m], off);
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < 45; ++m) red[warp][m] = A[m];
  __syncthreads();
  if (warp == 0) {
    for (int m = lane; m < 45; m += 32) {
      float s = 0.f;
      for (int k = 0; k < NT / 32; ++k) s += red[k][m];
      sA[m] = s;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < 45; ++m) A[m] = sA[m];
    float tr = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) tr += A[sfm_pk(i, i)];
    const float mean = tr / 9.f;
    float L[45];
    if (cholesky9_warp(A, 1e-6f * mean + 1e-20f, L, lane))
      cholesky9_warp(A, 1e-3f * mean + 1e-20f, L, lane);
    float f[9];
    inverse_iterate9_warp(L, 8, f, lane);
    rank2_project_warp(f, lane);
    const float t1[3] = {s1, c[0], c[1]}, t2[3] = {s2, c[2], c[3]};
    float Fw[9];
    denormalize_warp(f, t1, t2, Fw, lane);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 9; ++k) F[k] = Fw[k];
  }
  __syncthreads();
}

// The first design's fmat_refit_verify for pair b (its body, the eight-point
// solve by warp 0), from the winner's F: its consensus w over all rows, the weighted eight-point
// refit with rank 2, the final errors, inliers and count, and verify_pair's
// gates (>= 8 valid rows, min_inliers, min_inlier_ratio, the mean inlier
// error, the four inlier-masked standard deviations against min_spread).
__device__ void refit_verify(int b, int N, const float Fb[9], float (*sp)[MAXN], float* sw,
                             const uint8_t* sv, float (*red)[45], float* sA, float* sF,
                             const Gates& g, const VerifyOut& out) {
  const size_t row0 = (size_t)b * N;
  float n_valid = 0.f;
  for (int n = threadIdx.x; n < N; n += NT) {
    const bool v = sv[n] != 0;
    sw[n] = (v && sfm_sym_epipolar(Fb, sp[0][n], sp[1][n], sp[2][n], sp[3][n]) < g.thr) ? 1.f
                                                                                         : 0.f;
    n_valid += v ? 1.f : 0.f;
  }
  sfm_block_sum<NT, 1>(&n_valid, reinterpret_cast<float(*)[1]>(&red[0][0]));
  const int n_matches = (int)n_valid;
  const bool ok = n_matches >= 8;

  eight_point(sp, sw, N, red, sA, sF);
  float F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = sF[k];

  float acc2[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // count, error sum, x1, y1, x2, y2
  for (int n = threadIdx.x; n < N; n += NT) {
    const float err = sfm_sym_epipolar(F, sp[0][n], sp[1][n], sp[2][n], sp[3][n]);
    const bool inl = err < g.thr && sv[n] && ok;
    out.errors[row0 + n] = err;
    out.inliers[row0 + n] = inl;
    sw[n] = inl ? 1.f : 0.f;
    if (inl) {
      acc2[0] += 1.f;
      acc2[1] += err;
#pragma unroll
      for (int m = 0; m < 4; ++m) acc2[2 + m] += sp[m][n];
    }
  }
  sfm_block_sum<NT, 6>(acc2, reinterpret_cast<float(*)[6]>(&red[0][0]));
  const float wn = fmaxf(acc2[0], 1e-12f);

  float var[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += NT) {
    if (sw[n] == 0.f) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float d = sp[m][n] - acc2[2 + m] / wn;
      var[m] += d * d;
    }
  }
  sfm_block_sum<NT, 4>(var, reinterpret_cast<float(*)[4]>(&red[0][0]));

  if (threadIdx.x == 0) {
    const int n_inl = (int)acc2[0];
    const float ratio = (float)n_inl / fmaxf((float)n_matches, 1.f);
    const float mean_err = acc2[1] / fmaxf((float)n_inl, 1.f);
    bool spread = true;
#pragma unroll
    for (int m = 0; m < 4; ++m) spread = spread && sqrtf(var[m] / wn) > g.min_spread;
#pragma unroll
    for (int k = 0; k < 9; ++k) out.F[b * 9 + k] = F[k];
    out.num_matches[b] = n_matches;
    out.num_inliers[b] = n_inl;
    out.inlier_ratio[b] = ratio;
    out.mean_error[b] = mean_err;
    out.well_distributed[b] = spread;
    out.ok[b] = ok;
    out.accept[b] = ok && n_inl >= g.min_inliers && ratio >= g.min_ratio &&
                    mean_err <= g.max_err && spread;
  }
}

// Grid (tiles, pairs). work: per pair a ticket and each tile's best (score
// bits, index, count); zero on entry.
__global__ void __launch_bounds__(NT) fmat_ransac_kernel(
    const float* __restrict__ pts1, const float* __restrict__ pts2,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ idx, int H, int N, int NS,
    Gates g, int* __restrict__ work, VerifyOut out) {
  __shared__ float sp[4][MAXN];  // x1, y1, x2, y2
  __shared__ float sw[MAXN];
  __shared__ uint8_t sv[MAXN];
  __shared__ float red[NT / 32][45];
  __shared__ float sF[9], sA[45];
  __shared__ float sH[HT][9];            // the tile's hypotheses
  __shared__ float se[2][HT][CH + 1];    // a chunk of the walk's errors (odd stride)
  __shared__ int s_best, s_last, s_ns;
  const int tile = blockIdx.x, T = gridDim.x, b = blockIdx.y;
  const size_t row0 = (size_t)b * N;
  if (threadIdx.x == 0) s_ns = 0;
  __syncthreads();
  int ns = 0;   // one past the last valid scoring row: the walk ends there
  for (int n = threadIdx.x; n < N; n += NT) {
    sp[0][n] = pts1[(row0 + n) * 2];
    sp[1][n] = pts1[(row0 + n) * 2 + 1];
    sp[2][n] = pts2[(row0 + n) * 2];
    sp[3][n] = pts2[(row0 + n) * 2 + 1];
    sv[n] = valid[row0 + n] != 0;
    if (sv[n] && n < NS) ns = n + 1;
  }
  if (ns > 0) atomicMax(&s_ns, ns);
  __syncthreads();
  ns = s_ns;

  // The tile's hypotheses: solved by threads 0-63, stored once.
  const int j = threadIdx.x % HT, q = threadIdx.x / HT;
  const int h = tile * HT + j;
  if (threadIdx.x < HT && h < H) {
    const size_t g_h = (size_t)b * H + h;
    float F[9];
    hypothesis(sp, idx + g_h * 8, N, F);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      sH[j][k] = F[k];
      out.Fs[g_h * 9 + k] = F[k];
    }
    __threadfence();  // F before the tile's ticket: the last tile reads the winner's
  }
  __syncthreads();

  // The walk: thread (j, q) computes hypothesis j's errors at the valid rows
  // of points c + 8 q .. c + 8 q + 7 of each chunk c; thread j < 64 adds them
  // in order (an invalid row adds nothing, as the first design skipped it).
  float F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = sH[j][k];
  int count = 0;
  float err_sum = 0.f;
  for (int c = 0, buf = 0; c < ns; c += CH, buf ^= 1) {
    if (h < H) {
#pragma unroll
      for (int u = 0; u < CH / Q; ++u) {
        const int n = c + (CH / Q) * q + u;
        if (n < ns && sv[n])
          se[buf][j][(CH / Q) * q + u] = sfm_sym_epipolar(F, sp[0][n], sp[1][n], sp[2][n],
                                                          sp[3][n]);
      }
    }
    __syncthreads();
    if (q == 0 && h < H) {
      for (int u = 0; u < CH && c + u < ns; ++u) {
        const float err = se[buf][j][u];
        if (sv[c + u] && err < g.thr) {
          ++count;
          err_sum += err;
        }
      }
    }
  }
  SfmCand best{-INFINITY, INT_MAX, 0};
  if (q == 0 && h < H) best = SfmCand{sfm_ransac_score(count, err_sum, g.thr), h, count};
  best = sfm_block_best<NT>(best);

  // The pair's last tile to finish picks the winner (any order: a total one).
  int* ticket = work + (size_t)b * (1 + 3 * T);
  int* tiles = ticket + 1;
  if (threadIdx.x == 0) {
    tiles[3 * tile] = __float_as_int(best.score);
    tiles[3 * tile + 1] = best.h;
    tiles[3 * tile + 2] = best.count;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == T - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x == 0) {
    __threadfence();
    SfmCand w{-INFINITY, INT_MAX, 0};
    for (int k = 0; k < T; ++k)
      w = sfm_cand_max(w, SfmCand{__int_as_float(__ldcg(tiles + 3 * k)), __ldcg(tiles + 3 * k + 1),
                                  __ldcg(tiles + 3 * k + 2)});
    s_best = w.h == INT_MAX ? 0 : w.h;
    out.best[b] = s_best;
    out.count[b] = w.count;
  }
  __syncthreads();
  float Fb[9];
  {
    const int64_t hb = sfm_clamp_index(s_best, H - 1);
#pragma unroll
    for (int k = 0; k < 9; ++k) Fb[k] = __ldcg(out.Fs + ((size_t)b * H + hb) * 9 + k);
  }
  refit_verify(b, N, Fb, sp, sw, sv, red, sA, sF, g, out);
}

}  // namespace

SFM_API int sfm_fmat_ransac(const void* pts1, const void* pts2, const void* valid,
                            const void* idx, int B, int H, int N, int NS, int tiles, float thr,
                            int min_inliers, float min_ratio, float max_err, float min_spread,
                            void* work, void* Fs, void* best, void* count, void* F,
                            void* inliers, void* errors, void* num_matches, void* num_inliers,
                            void* inlier_ratio, void* mean_error, void* well_distributed,
                            void* accept, void* ok, void* stream) {
  // work holds B x (1 + 3 tiles) ints: the wrapper's tiles must be the grid's.
  if (N > MAXN || N < 1 || H < 1 || NS < 0 || NS > N || tiles != (H + HT - 1) / HT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const VerifyOut out{static_cast<float*>(Fs),         static_cast<int64_t*>(best),
                        static_cast<int64_t*>(count),     static_cast<float*>(F),
                        static_cast<uint8_t*>(inliers),   static_cast<float*>(errors),
                        static_cast<int*>(num_matches),   static_cast<int*>(num_inliers),
                        static_cast<float*>(inlier_ratio), static_cast<float*>(mean_error),
                        static_cast<uint8_t*>(well_distributed), static_cast<uint8_t*>(accept),
                        static_cast<uint8_t*>(ok)};
    const Gates g{thr, min_inliers, min_ratio, max_err, min_spread};
    const dim3 grid(tiles, B);
    fmat_ransac_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts1), static_cast<const float*>(pts2),
        static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(idx), H, N, NS, g,
        static_cast<int*>(work), out);
  }
  return static_cast<int>(cudaGetLastError());
}
