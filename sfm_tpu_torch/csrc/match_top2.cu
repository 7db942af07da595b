// Kernel K1: per-row top-2 of the squared-L2 descriptor distance, batched over pairs.
//
// Replaces the distance/top-2 part of sfm_tpu/matching/core.py::_match_descriptors
// (the XLA program the sweep vmaps over chunks of 32 pairs): there a (K1, K2) f32
// distance matrix is written to device memory and read back by four min-passes
// per direction. Here the matrix never leaves the block.
//
// What bounds it on the H100: float32 FMAs on the CUDA cores (2*K1*K2*D per pair
// and direction; 1.07 GFLOP at K = 2048, D = 128). The tensor cores would need
// TF32/bf16 inputs, which the port does not allow on descriptors.
//
// Design (simple first): one block per (pair, 64 query rows); the 64 x 64
// distance tiles of dot_tile.cuh stream over the other set's columns. After a
// column tile, each thread folds its 16 distances into a running top-2 per row;
// the 16 lanes that share a row merge theirs with warp shuffles at the end.
//
// Semantics (the plain twin's, i.e. jnp.min/argmin): d = max(2 - 2 a.b, 0), +inf
// for an invalid column and for every column of an invalid row; ties go to the
// lowest column index; an all-inf row returns index 0; "second" is the minimum
// over every column but the best one (equal to best on a tie).
#include "dot_tile.cuh"

namespace {

using namespace sfm_tile;

__global__ void __launch_bounds__(NT) match_top2_kernel(
    const float* __restrict__ d1, const uint8_t* __restrict__ v1,
    const float* __restrict__ d2, const uint8_t* __restrict__ v2,
    int K1, int K2, int D,
    int* __restrict__ out_idx, float* __restrict__ out_best,
    float* __restrict__ out_second) {
  __shared__ Stage stage;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const float* A = d1 + (size_t)b * K1 * D;
  const float* Bm = d2 + (size_t)b * K2 * D;
  const uint8_t* vcol = v2 + (size_t)b * K2;

  Top2 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = top2_empty();

  for (int c0 = 0; c0 < K2; c0 += TC) {
    float acc[4][4];
    dots(stage, A, K1, r0, Bm, K2, c0, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // increasing column order
      const int gc = c0 + tx() + 16 * j;
      if (gc >= K2) continue;
      const bool col_ok = vcol[gc] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) top2_push(top[i], distance(acc[i][j], col_ok), gc);
    }
  }

  top2_merge_lanes(top);
  if (tx() == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty() + 16 * i;
      if (row >= K1) continue;
      const size_t o = (size_t)b * K1 + row;
      const bool row_ok = v1[o] != 0;
      out_idx[o] = (row_ok && top[i].idx != INT_MAX) ? top[i].idx : 0;
      out_best[o] = row_ok ? top[i].best : INFINITY;
      out_second[o] = row_ok ? top[i].second : INFINITY;
    }
  }
}

}  // namespace

SFM_API int sfm_match_top2(const void* d1, const void* v1, const void* d2,
                           const void* v2, int B, int K1, int K2, int D,
                           void* idx, void* best, void* second, void* stream) {
  const dim3 grid((K1 + TR - 1) / TR, B);
  match_top2_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d1), static_cast<const uint8_t*>(v1),
      static_cast<const float*>(d2), static_cast<const uint8_t*>(v2), K1, K2, D,
      static_cast<int*>(idx), static_cast<float*>(best),
      static_cast<float*>(second));
  return static_cast<int>(cudaGetLastError());
}
