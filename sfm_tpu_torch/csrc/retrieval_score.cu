// Kernel K1-r: the retrieval score of a candidate pair, its mutual ratio-test
// match count over both images' top-S keypoints.
//
// Replaces sfm_tpu/matching/retrieval.py::_score_chunk (:37), which vmaps a
// (S, S) distance matrix per pair of a 1,024-pair chunk through device memory
// (plus the row top-2 passes and a column argmin pass) to return one int32.
//
// What bounds it on the H100: float32 FMAs, 2 * S^2 * D per pair (16.8 MFLOP at
// S = 256, D = 128); the 11,175 pairs of a 150-image scene are 0.19 TFLOP.
//
// Design: one block per pair, no gathered copies: the block reads both images'
// descriptors from the (N, S, D) table. It walks the S x S matrix in the 64 x 64
// tiles of dot_tile.cuh, row tile by row tile. Within a row tile each thread
// keeps the running top-2 of its rows (as K1); after every tile the per-column
// lexicographic (distance, row) minimum of the tile is reduced through shared
// memory into the column state of all S columns. When every tile is done, both
// directions are complete in shared memory and the mutual test back[best] == i
// is a lookup; the block's count is one atomic per thread into shared memory.
// Semantics follow the twin (jnp.min/argmin ties: the lowest index; an
// all-inf column's argmin is row 0).
#include "dot_tile.cuh"

namespace {

using namespace sfm_tile;

constexpr int MAX_S = 1024;

__global__ void __launch_bounds__(NT) retrieval_score_kernel(
    const float* __restrict__ desc, const uint8_t* __restrict__ valid,
    const int* __restrict__ pairs, int S, int D, float r2, int* __restrict__ counts) {
  __shared__ Stage stage;
  __shared__ float row_best[MAX_S], row_second[MAX_S], col_best[MAX_S];
  __shared__ int row_idx[MAX_S], col_idx[MAX_S];
  __shared__ float red_d[16][TC];
  __shared__ int red_i[16][TC];
  __shared__ int total;

  const int p = blockIdx.x;
  const int a = pairs[2 * p], b = pairs[2 * p + 1];
  const float* A = desc + (size_t)a * S * D;
  const float* B = desc + (size_t)b * S * D;
  const uint8_t* va = valid + (size_t)a * S;
  const uint8_t* vb = valid + (size_t)b * S;

  for (int k = threadIdx.x; k < S; k += NT) {
    col_best[k] = INFINITY;
    col_idx[k] = INT_MAX;
  }
  if (threadIdx.x == 0) total = 0;
  __syncthreads();

  for (int r0 = 0; r0 < S; r0 += TR) {
    Top2 top[4];
    bool row_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      top[i] = top2_empty();
      const int row = r0 + ty() + 16 * i;
      row_ok[i] = row < S && va[row] != 0;
    }
    for (int c0 = 0; c0 < S; c0 += TC) {
      float acc[4][4];
      dots(stage, A, S, r0, B, S, c0, D, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx() + 16 * j;
        const bool col_ok = col < S && vb[col] != 0;
        float cb = INFINITY;
        int ci = INT_MAX;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ty() + 16 * i;
          const float d = distance(acc[i][j], row_ok[i] && col_ok);
          if (col < S) top2_push(top[i], d, col);
          if (row < S && (d < cb || (d == cb && row < ci))) {
            cb = d;
            ci = row;
          }
        }
        red_d[ty()][tx() + 16 * j] = cb;
        red_i[ty()][tx() + 16 * j] = ci;
      }
      __syncthreads();
      if (threadIdx.x < TC && c0 + threadIdx.x < S) {
        const int col = c0 + threadIdx.x;
        float cb = col_best[col];
        int ci = col_idx[col];
        for (int t = 0; t < 16; ++t) {
          const float d = red_d[t][threadIdx.x];
          const int i = red_i[t][threadIdx.x];
          if (d < cb || (d == cb && i < ci)) {
            cb = d;
            ci = i;
          }
        }
        col_best[col] = cb;
        col_idx[col] = ci;
      }
      // The next tile's dots() synchronizes before red_* is written again.
    }
    top2_merge_lanes(top);
    if (tx() == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty() + 16 * i;
        if (row >= S) continue;
        row_best[row] = top[i].best;
        row_idx[row] = top[i].idx;
        row_second[row] = top[i].second;
      }
    }
  }
  __syncthreads();

  int n = 0;
  for (int row = threadIdx.x; row < S; row += NT) {
    const float best = row_best[row];
    if (va[row] == 0 || !isfinite(best) || !(best < r2 * row_second[row])) continue;
    const int back = col_idx[row_idx[row]];
    n += (back == INT_MAX ? 0 : back) == row;
  }
  if (n) atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[p] = total;
}

}  // namespace

SFM_API int sfm_retrieval_score(const void* desc, const void* valid, const void* pairs,
                                int N, int S, int D, int C, float r2, void* counts,
                                void* stream) {
  (void)N;
  if (S > MAX_S || D % TK) return static_cast<int>(cudaErrorInvalidValue);
  if (C > 0) {
    retrieval_score_kernel<<<C, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(desc), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(pairs), S, D, r2, static_cast<int*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
