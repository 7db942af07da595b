// Kernel K2, the rest of it: the eight-point hypothesis solve, and the winner's
// consensus, weighted rank-2 refit and verify gates (two entries).
//
// Replaces, of sfm_tpu/estimators/fundamental.py::estimate_fundamental_ransac
// (:20), the vmapped epipolar.py::eight_point(..., enforce_rank2=False,
// null_iters=3, null_fallback=False) over the RANSAC samples and, after
// ransac_select, the winner's consensus over all rows, the weighted eight_point
// refit (utils/linalg.py::smallest_eigvec with its fallback-shift tier, then
// the rank-2 SVD) and the final inliers; and the gates of
// sfm_tpu/matching/verify.py::verify_pair (:30). XLA ran each as a chain of
// batched small matmuls, a column loop of the clamped Cholesky, triangular
// solves, an SVD and masked reductions, every intermediate in device memory.
//
// fmat_hypotheses: one thread per (pair, hypothesis), 32 x 512 at the default
// settings. The 8 sampled rows are gathered, Hartley-normalized, and their 45
// distinct A^T A entries summed in registers; A^T A + (1e-6 mean_eig + 1e-20) I
// is factored in place by the clamped Cholesky in the reference's column order
// (a nonpositive pivot becomes 1e-30, never a failure; no fallback tier), then
// 3 steps of inverse iteration from 1 + 1e-3 * arange(9), the denormalization
// F = T2^T Fn T1 and the unit Frobenius norm.
//
// fmat_refit_verify: one block per pair, N <= 1024 rows in shared memory. The
// winner's symmetric epipolar error gives the weights; the weighted Hartley
// normalization and the 9x9 A^T A are block reductions (sfm_block_sum,
// deterministic); thread 0 runs smallest_eigvec (8 steps, the 1e-3 fallback
// shift when a pivot of the 1e-6 factor is nonpositive) and the rank-2
// projection without an SVD: F (I - v v^T), v the unit eigenvector of F^T F
// for its smallest eigenvalue (the dominant one of the 3x3 adjugate, by
// repeated squaring), which is the SVD truncation whatever signs an SVD
// picks. Then the final errors, inliers and count, and verify_pair's gates: >= 8
// valid rows, min_inliers, min_inlier_ratio, the mean inlier error, and the
// four inlier-masked standard deviations against min_spread.
//
// What bounds it on the H100: neither rate. The hypothesis solve is ~2 kFLOP
// a thread (25 MFLOP for 16k threads, < 1 us at the f32 peak) and moves ~1.6
// MB (sample indices in, F out: ~0.5 us at 3.35 TB/s); the refit moves ~22 KB
// a pair. Both are latency chains: a serial 9x9 factorization per thread, and
// in the refit five block reductions and thread 0's solve between them.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXN = 1024;  // fmat_refit_verify: rows of one pair in shared memory

// Packed lower triangle of a symmetric 9x9: entry (i, j), j <= i.
__device__ __forceinline__ constexpr int pk(int i, int j) { return i * (i + 1) / 2 + j; }

// One row of eight_point's design matrix (x2^T F x1 = a . vec(F)), times w,
// added to the packed A^T A.
__device__ __forceinline__ void add_design_row(float x1, float y1, float x2, float y2, float w,
                                               float* A) {
  const float a[9] = {x2 * x1 * w, x2 * y1 * w, x2 * w, y2 * x1 * w, y2 * y1 * w,
                      y2 * w,      x1 * w,      y1 * w, w};
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) A[pk(i, j)] += a[i] * a[j];
}

// utils/linalg.py::_cholesky_clamped of the packed A + shift I, column by
// column, written to L (which may be A itself: each entry of A is read before
// its place is written). Returns whether a pivot was nonpositive.
__device__ __forceinline__ bool cholesky_clamped9(const float* A, float shift, float* L) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc += L[pk(j, k)] * L[pk(j, k)];
    const float s = (A[pk(j, j)] + shift) - acc;
    bad |= s <= 0.f;
    const float d = sqrtf(fmaxf(s, 1e-30f));
    L[pk(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < 9; ++i) {
      float r = 0.f;
#pragma unroll
      for (int k = 0; k < j; ++k) r += L[pk(i, k)] * L[pk(j, k)];
      L[pk(i, j)] = (A[pk(i, j)] - r) / d;
    }
  }
  return bad;
}

// smallest_eigvec's iteration on the factor: x <- (L L^T)^-1 x, normalized,
// from x0 = 1 + 1e-3 * arange(9).
__device__ __forceinline__ void inverse_iterate9(const float* L, int iters, float* x) {
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i] = 1.f + 1e-3f * (float)i;
  for (int it = 0; it < iters; ++it) {
    float y[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float s = x[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[pk(i, k)] * y[k];
      y[i] = s / L[pk(i, i)];
    }
#pragma unroll
    for (int i = 8; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < 9; ++k) s -= L[pk(k, i)] * x[k];
      x[i] = s / L[pk(i, i)];
    }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) n2 += x[i] * x[i];
    const float nrm = fmaxf(sqrtf(n2), 1e-30f);
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] /= nrm;
  }
}

// F = T2^T Fn T1 (T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]], given as
// (s, cx, cy)), then divided by max(||F||_F, 1e-12).
__device__ __forceinline__ void denormalize(const float* fn, const float* t1, const float* t2,
                                            float* F) {
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
  const float nrm = fmaxf(sqrtf(n2), 1e-12f);
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] /= nrm;
}

// Rank 2 without an SVD: F <- F (I - v v^T), v the unit eigenvector of F^T F
// for its smallest eigenvalue. adj(F^T F) = det (F^T F)^-1 has v as its
// dominant eigenvector (as utils/linalg.py::_smallest_eigvec_adjugate uses
// it), and is still v v^T times lambda_1 lambda_2 when F is singular; 12
// renormalized squarings raise it to the power 4096, so its other directions
// shrink by (sigma_3 / sigma_2)^8192 and every column is a multiple of v; v is
// the column of largest norm. A rank-1 F has adj = 0 and is left as it is.
__device__ void rank2_project(float* f) {
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i * 3 + j] = f[i] * f[j] + f[3 + i] * f[3 + j] + f[6 + i] * f[6 + j];
  // adj(M)[:, j] = row (j+1) x row (j+2).
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
#pragma unroll
    for (int e = 0; e < 9; ++e) P[e] = Q[e] / mx;
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
  const float v[3] = {P[jm] / nrm, P[3 + jm] / nrm, P[6 + jm] / nrm};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float fv = f[i * 3] * v[0] + f[i * 3 + 1] * v[1] + f[i * 3 + 2] * v[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) f[i * 3 + j] -= fv * v[j];
  }
}

__global__ void __launch_bounds__(NT) fmat_hypotheses_kernel(
    const float* __restrict__ pts1, const float* __restrict__ pts2,
    const int64_t* __restrict__ idx, int BH, int H, int N, float* __restrict__ Fs) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= BH) return;
  const size_t base = (size_t)(g / H) * N;
  float p[4][8];  // x1, y1, x2, y2 of the sample
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t j = sfm_clamp_index(idx[(size_t)g * 8 + k], N - 1);
    p[0][k] = pts1[(base + j) * 2];
    p[1][k] = pts1[(base + j) * 2 + 1];
    p[2][k] = pts2[(base + j) * 2];
    p[3][k] = pts2[(base + j) * 2 + 1];
  }
  // Hartley normalization of each image's 8 points (normalize_points, w = 1).
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
  for (int k = 0; k < 8; ++k) add_design_row(p[0][k], p[1][k], p[2][k], p[3][k], 1.f, A);
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) tr += A[pk(i, i)];
  cholesky_clamped9(A, 1e-6f * (tr / 9.f) + 1e-20f, A);
  float f[9], F[9];
  inverse_iterate9(A, 3, f);
  denormalize(f, T[0], T[1], F);
#pragma unroll
  for (int k = 0; k < 9; ++k) Fs[(size_t)g * 9 + k] = F[k];
}

struct VerifyOut {
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

__global__ void __launch_bounds__(NT) fmat_refit_verify_kernel(
    const float* __restrict__ Fs, const int64_t* __restrict__ best,
    const float* __restrict__ pts1, const float* __restrict__ pts2,
    const uint8_t* __restrict__ valid, int H, int N, float thr, int min_inliers,
    float min_ratio, float max_err, float min_spread, VerifyOut out) {
  __shared__ float sp[4][MAXN];  // x1, y1, x2, y2
  __shared__ float sw[MAXN];     // the winner's consensus, later the final inliers
  __shared__ uint8_t sv[MAXN];
  __shared__ float red[NT / 32][45];
  __shared__ float sF[9];
  const int b = blockIdx.x;
  const size_t row0 = (size_t)b * N;
  float Fb[9];
  {
    const int64_t h = sfm_clamp_index(best[b], H - 1);
#pragma unroll
    for (int k = 0; k < 9; ++k) Fb[k] = Fs[((size_t)b * H + h) * 9 + k];
  }

  // 1. The winner's consensus w over all rows; the weighted centroids.
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // sum w, w x1, w y1, w x2, w y2; valid rows
  for (int n = threadIdx.x; n < N; n += NT) {
    const float x1 = pts1[(row0 + n) * 2], y1 = pts1[(row0 + n) * 2 + 1];
    const float x2 = pts2[(row0 + n) * 2], y2 = pts2[(row0 + n) * 2 + 1];
    const bool v = valid[row0 + n] != 0;
    sp[0][n] = x1;
    sp[1][n] = y1;
    sp[2][n] = x2;
    sp[3][n] = y2;
    sv[n] = v;
    const float w = (v && sfm_sym_epipolar(Fb, x1, y1, x2, y2) < thr) ? 1.f : 0.f;
    sw[n] = w;
    acc[0] += w;
    acc[1] += x1 * w;
    acc[2] += y1 * w;
    acc[3] += x2 * w;
    acc[4] += y2 * w;
    acc[5] += v ? 1.f : 0.f;
  }
  sfm_block_sum<NT, 6>(acc, reinterpret_cast<float(*)[6]>(&red[0][0]));
  const float wsum = fmaxf(acc[0], 1e-12f);
  const float c[4] = {acc[1] / wsum, acc[2] / wsum, acc[3] / wsum, acc[4] / wsum};
  const int n_matches = (int)acc[5];
  const bool ok = n_matches >= 8;

  // 2. The weighted mean distances to the centroids.
  float md[2] = {0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += NT) {
    const float w = sw[n];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float dx = sp[2 * m][n] - c[2 * m], dy = sp[2 * m + 1][n] - c[2 * m + 1];
      md[m] += sqrtf(dx * dx + dy * dy) * w;
    }
  }
  sfm_block_sum<NT, 2>(md, reinterpret_cast<float(*)[2]>(&red[0][0]));
  const float s1 = 1.41421356237309515f / fmaxf(md[0] / wsum, 1e-12f);
  const float s2 = 1.41421356237309515f / fmaxf(md[1] / wsum, 1e-12f);

  // 3. The weighted 9x9 A^T A of the normalized rows.
  float A[45];
#pragma unroll
  for (int e = 0; e < 45; ++e) A[e] = 0.f;
  for (int n = threadIdx.x; n < N; n += NT) {
    const float w = sw[n];
    if (w == 0.f) continue;
    add_design_row((sp[0][n] - c[0]) * s1, (sp[1][n] - c[1]) * s1, (sp[2][n] - c[2]) * s2,
                   (sp[3][n] - c[3]) * s2, w, A);
  }
  sfm_block_sum<NT, 45>(A, red);

  // 4. Thread 0: smallest_eigvec with its fallback tier, rank 2, denormalize.
  if (threadIdx.x == 0) {
    float tr = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) tr += A[pk(i, i)];
    const float mean = tr / 9.f;
    float L[45];
    if (cholesky_clamped9(A, 1e-6f * mean + 1e-20f, L)) cholesky_clamped9(A, 1e-3f * mean + 1e-20f, L);
    float f[9];
    inverse_iterate9(L, 8, f);
    rank2_project(f);
    const float t1[3] = {s1, c[0], c[1]}, t2[3] = {s2, c[2], c[3]};
    denormalize(f, t1, t2, sF);
  }
  __syncthreads();
  float F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = sF[k];

  // 5. Final errors, inliers, count; the inliers' error sum and coordinate sums.
  float acc2[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // count, error sum, x1, y1, x2, y2
  for (int n = threadIdx.x; n < N; n += NT) {
    const float err = sfm_sym_epipolar(F, sp[0][n], sp[1][n], sp[2][n], sp[3][n]);
    const bool inl = err < thr && sv[n] && ok;
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

  // 6. The four masked variances (verify.py::_masked_std).
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
    for (int m = 0; m < 4; ++m) spread = spread && sqrtf(var[m] / wn) > min_spread;
#pragma unroll
    for (int k = 0; k < 9; ++k) out.F[b * 9 + k] = F[k];
    out.num_matches[b] = n_matches;
    out.num_inliers[b] = n_inl;
    out.inlier_ratio[b] = ratio;
    out.mean_error[b] = mean_err;
    out.well_distributed[b] = spread;
    out.ok[b] = ok;
    out.accept[b] = ok && n_inl >= min_inliers && ratio >= min_ratio && mean_err <= max_err &&
                    spread;
  }
}

}  // namespace

SFM_API int sfm_fmat_hypotheses(const void* pts1, const void* pts2, const void* idx, int B,
                                int H, int N, void* Fs, void* stream) {
  const int BH = B * H;
  if (BH > 0) {
    fmat_hypotheses_kernel<<<(BH + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts1), static_cast<const float*>(pts2),
        static_cast<const int64_t*>(idx), BH, H, N, static_cast<float*>(Fs));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_fmat_refit_verify(const void* Fs, const void* best, const void* pts1,
                                  const void* pts2, const void* valid, int B, int H, int N,
                                  float thr, int min_inliers, float min_ratio, float max_err,
                                  float min_spread, void* F, void* inliers, void* errors,
                                  void* num_matches, void* num_inliers, void* inlier_ratio,
                                  void* mean_error, void* well_distributed, void* accept,
                                  void* ok, void* stream) {
  if (N > MAXN || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const VerifyOut out{static_cast<float*>(F),       static_cast<uint8_t*>(inliers),
                        static_cast<float*>(errors),  static_cast<int*>(num_matches),
                        static_cast<int*>(num_inliers), static_cast<float*>(inlier_ratio),
                        static_cast<float*>(mean_error), static_cast<uint8_t*>(well_distributed),
                        static_cast<uint8_t*>(accept), static_cast<uint8_t*>(ok)};
    fmat_refit_verify_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Fs), static_cast<const int64_t*>(best),
        static_cast<const float*>(pts1), static_cast<const float*>(pts2),
        static_cast<const uint8_t*>(valid), H, N, thr, min_inliers, min_ratio, max_err,
        min_spread, out);
  }
  return static_cast<int>(cudaGetLastError());
}
