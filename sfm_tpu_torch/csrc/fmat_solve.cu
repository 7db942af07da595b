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
#include "sfm_geom.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXN = 1024;  // fmat_refit_verify: rows of one pair in shared memory

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
  for (int k = 0; k < 8; ++k) sfm_add_design_row(p[0][k], p[1][k], p[2][k], p[3][k], 1.f, A);
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) tr += A[sfm_pk(i, i)];
  sfm_cholesky_clamped<9>(A, 1e-6f * (tr / 9.f) + 1e-20f, A);
  float f[9], F[9];
  sfm_inverse_iterate<9>(A, 3, f);
  sfm_denormalize(f, T[0], T[1], F);
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

  // 1. The winner's consensus w over all rows; the valid rows.
  float n_valid = 0.f;
  for (int n = threadIdx.x; n < N; n += NT) {
    const float x1 = pts1[(row0 + n) * 2], y1 = pts1[(row0 + n) * 2 + 1];
    const float x2 = pts2[(row0 + n) * 2], y2 = pts2[(row0 + n) * 2 + 1];
    const bool v = valid[row0 + n] != 0;
    sp[0][n] = x1;
    sp[1][n] = y1;
    sp[2][n] = x2;
    sp[3][n] = y2;
    sv[n] = v;
    sw[n] = (v && sfm_sym_epipolar(Fb, x1, y1, x2, y2) < thr) ? 1.f : 0.f;
    n_valid += v ? 1.f : 0.f;
  }
  sfm_block_sum<NT, 1>(&n_valid, reinterpret_cast<float(*)[1]>(&red[0][0]));
  const int n_matches = (int)n_valid;
  const bool ok = n_matches >= 8;

  // 2-4. The weighted eight-point refit with its rank-2 projection.
  sfm_eight_point_block<NT>(sp[0], sp[1], sp[2], sp[3], sw, N, red, sF);
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
