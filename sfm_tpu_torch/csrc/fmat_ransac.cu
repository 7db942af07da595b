// Kernel K2: score every F-RANSAC hypothesis of a batch of pairs and pick the winner.
//
// Replaces the scoring + selection part of sfm_tpu/estimators/fundamental.py::
// estimate_fundamental_ransac (the vmapped symmetric_epipolar_distance over an
// (iters, N_score) error matrix, then ransac.py::ransac_select). There the error
// matrix (512 x 256 f32 per pair) is written to device memory and reduced by
// separate passes; here each hypothesis's count and error sum stay in registers.
//
// What bounds it on the H100: float32 arithmetic and the one division/sqrt pair
// per point and line (~45 FLOP per hypothesis and point: 5.9 MFLOP per pair at
// H = 512, N = 256); the inputs are a few KB per pair, so memory is no limit.
// With one block per pair, a 32-pair chunk fills 32 of the 132 SMs.
//
// Design (simple first): one block per pair; the scoring subset (N points, two
// images, valid flag) sits in shared memory; one thread per hypothesis walks the
// points and accumulates count and error sum; a block argmax picks the winner.
//
// Semantics: ransac_select's and the epipolar distance of sfm_common.cuh (shared
// with K6 and fmat_solve.cu).
#include <climits>

#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) fmat_score_select_kernel(
    const float* __restrict__ Fs, const float* __restrict__ pts1,
    const float* __restrict__ pts2, const uint8_t* __restrict__ valid, int H,
    int N, float thr, int* __restrict__ best_out, int* __restrict__ count_out) {
  extern __shared__ float sm[];
  float* sx1 = sm;
  float* sy1 = sm + N;
  float* sx2 = sm + 2 * N;
  float* sy2 = sm + 3 * N;
  int* sv = reinterpret_cast<int*>(sm + 4 * N);

  const int b = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += NT) {
    const size_t o = (size_t)b * N + n;
    sx1[n] = pts1[2 * o];
    sy1[n] = pts1[2 * o + 1];
    sx2[n] = pts2[2 * o];
    sy2[n] = pts2[2 * o + 1];
    sv[n] = valid[o] != 0;
  }
  __syncthreads();

  SfmCand best{-INFINITY, INT_MAX, 0};
  for (int h = threadIdx.x; h < H; h += NT) {
    const float* F = Fs + ((size_t)b * H + h) * 9;
    float f[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = F[i];
    int count = 0;
    float err_sum = 0.f;
    for (int n = 0; n < N; ++n) {
      if (!sv[n]) continue;
      const float err = sfm_sym_epipolar(f, sx1[n], sy1[n], sx2[n], sy2[n]);
      if (err < thr) {
        ++count;
        err_sum += err;
      }
    }
    best = sfm_cand_max(best, SfmCand{sfm_ransac_score(count, err_sum, thr), h, count});
  }
  best = sfm_block_best<NT>(best);
  if (threadIdx.x == 0) {
    best_out[b] = best.h == INT_MAX ? 0 : best.h;
    count_out[b] = best.count;
  }
}

}  // namespace

SFM_API int sfm_fmat_score_select(const void* Fs, const void* pts1,
                                  const void* pts2, const void* valid, int B,
                                  int H, int N, float thr, void* best,
                                  void* count, void* stream) {
  const size_t smem = (size_t)N * 5 * sizeof(float);
  fmat_score_select_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Fs), static_cast<const float*>(pts1),
      static_cast<const float*>(pts2), static_cast<const uint8_t*>(valid), H, N,
      thr, static_cast<int*>(best), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
