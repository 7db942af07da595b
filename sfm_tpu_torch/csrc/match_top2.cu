// Kernel K1: per-row top-2 of the squared-L2 descriptor distance, batched over pairs.
//
// Replaces the distance/top-2 part of sfm_tpu/matching/core.py::_match_descriptors
// (the XLA program the sweep vmaps over chunks of 32 pairs) and, with the two
// entries below, the rest of it (:81-105): there a (K1, K2) f32 distance matrix
// is written to device memory and read back by the row min-passes and the
// column argmin. Here the matrix never leaves the block.
//
// What bounds it on the H100: float32 FMAs on the CUDA cores (2*K1*K2*D per
// pair, both directions from one product; 1.07 GFLOP at K = 2048, D = 128).
// The tensor cores would need TF32/bf16 inputs, which the port does not allow
// on descriptors. The epilogue entries move ~20 bytes a row.
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
//
// The mutual check's column argmin back = argmin(dist, axis=0) comes from the
// same tiles when the caller asks for it: each column's key is the u64
// (float bits << 32 | row). Distances are >= 0 or +inf, so the keys order as
// (distance, row) and the minimum is jnp.argmin's lowest-row tie; an invalid
// row pushes +inf, so a column that is +inf in every row gets row 0. Per
// column tile the block reduces its 64 rows (registers, one shuffle, shared
// atomicMin), then adds one global atomicMin per column.
//
// match_epilogue (second entry) is the rest of _match_descriptors up to the
// compaction: the Lowe ratio, the mutual test back[best_j] == row and the
// score -d_best (or -inf) that topk_rows compacts; match_compact (third entry)
// is the compaction's gathers and wheres after topk_rows. One thread per row.
#include "dot_tile.cuh"

namespace {

using namespace sfm_tile;

constexpr unsigned long long kKeyMax = ~0ull;

__device__ __forceinline__ unsigned long long col_key(float d, int row) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)row;
}

__global__ void __launch_bounds__(NT) match_top2_kernel(
    const float* __restrict__ d1, const uint8_t* __restrict__ v1,
    const float* __restrict__ d2, const uint8_t* __restrict__ v2,
    int K1, int K2, int D,
    int* __restrict__ out_idx, float* __restrict__ out_best,
    float* __restrict__ out_second, unsigned long long* __restrict__ back_key) {
  __shared__ Stage stage;
  __shared__ unsigned long long s_col[TC];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const float* A = d1 + (size_t)b * K1 * D;
  const float* Bm = d2 + (size_t)b * K2 * D;
  const uint8_t* vcol = v2 + (size_t)b * K2;

  const bool want_back = back_key != nullptr;
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty() + 16 * i;
    row_ok[i] = row < K1 && v1[(size_t)b * K1 + row] != 0;
  }
  if (threadIdx.x < TC) s_col[threadIdx.x] = kKeyMax;

  Top2 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = top2_empty();

  for (int c0 = 0; c0 < K2; c0 += TC) {
    float acc[4][4];
    dots(stage, A, K1, r0, Bm, K2, c0, D, acc);  // its barriers order s_col's reset
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // increasing column order
      const int gc = c0 + tx() + 16 * j;
      const bool col_ok = gc < K2 && vcol[gc] != 0;
      unsigned long long key = kKeyMax;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = distance(acc[i][j], col_ok);
        if (gc < K2) top2_push(top[i], d, gc);
        const int row = r0 + ty() + 16 * i;
        if (row < K1) key = min(key, col_key(row_ok[i] ? d : INFINITY, row));
      }
      if (want_back) {
        // Lanes l and l ^ 16 hold the same column (ty and ty + 1).
        key = min(key, __shfl_xor_sync(0xffffffffu, key, 16));
        if (gc < K2 && (threadIdx.x & 16) == 0) atomicMin(&s_col[tx() + 16 * j], key);
      }
    }
    if (want_back) {
      __syncthreads();
      if (threadIdx.x < TC) {
        const int gc = c0 + threadIdx.x;
        if (gc < K2) atomicMin(&back_key[(size_t)b * K2 + gc], s_col[threadIdx.x]);
        s_col[threadIdx.x] = kKeyMax;
      }
    }
  }

  top2_merge_lanes(top);
  if (tx() == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty() + 16 * i;
      if (row >= K1) continue;
      const size_t o = (size_t)b * K1 + row;
      out_idx[o] = (row_ok[i] && top[i].idx != INT_MAX) ? top[i].idx : 0;
      out_best[o] = row_ok[i] ? top[i].best : INFINITY;
      out_second[o] = row_ok[i] ? top[i].second : INFINITY;
    }
  }
}

// back = the row of each column's minimum key (the low 32 bits).
__global__ void __launch_bounds__(256) back_index_kernel(
    const unsigned long long* __restrict__ key, int n, int* __restrict__ back) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) back[i] = (int)(unsigned)(key[i] & 0xffffffffull);
}

__global__ void __launch_bounds__(256) match_epilogue_kernel(
    const int* __restrict__ best_j, const float* __restrict__ d_best,
    const float* __restrict__ d_second, const uint8_t* __restrict__ v1,
    const int* __restrict__ back, int B, int K1, int K2, float ratio2,
    float* __restrict__ score) {
  const int g = blockIdx.x * 256 + threadIdx.x;
  if (g >= B * K1) return;
  const int b = g / K1, row = g % K1;
  const float db = d_best[g];
  bool good = db < ratio2 * d_second[g] && v1[g] != 0 && isfinite(db);
  if (back != nullptr) good = good && back[(size_t)b * K2 + best_j[g]] == row;
  score[g] = good ? -db : -INFINITY;
}

__global__ void __launch_bounds__(256) match_compact_kernel(
    const float* __restrict__ top, const int64_t* __restrict__ order,
    const int* __restrict__ best_j, int B, int K1, int k, int M,
    int64_t* __restrict__ idx1, int64_t* __restrict__ idx2, uint8_t* __restrict__ valid,
    float* __restrict__ dist) {
  const int g = blockIdx.x * 256 + threadIdx.x;
  if (g >= B * M) return;
  const int b = g / M, m = g % M;
  const float s = m < k ? top[(size_t)b * k + m] : -INFINITY;
  const bool ok = isfinite(s);
  const int o = ok ? (int)order[(size_t)b * k + m] : 0;
  idx1[g] = o;
  idx2[g] = ok ? best_j[(size_t)b * K1 + o] : 0;
  valid[g] = ok;
  dist[g] = ok ? -s : 0.f;
}

}  // namespace

SFM_API int sfm_match_top2(const void* d1, const void* v1, const void* d2,
                           const void* v2, int B, int K1, int K2, int D,
                           void* idx, void* best, void* second, void* back_key, void* back,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* key = static_cast<unsigned long long*>(back_key);
  if (key != nullptr) {
    const cudaError_t e = cudaMemsetAsync(key, 0xff, (size_t)B * K2 * sizeof(*key), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((K1 + TR - 1) / TR, B);
  match_top2_kernel<<<grid, NT, 0, st>>>(
      static_cast<const float*>(d1), static_cast<const uint8_t*>(v1),
      static_cast<const float*>(d2), static_cast<const uint8_t*>(v2), K1, K2, D,
      static_cast<int*>(idx), static_cast<float*>(best),
      static_cast<float*>(second), key);
  if (key != nullptr && B * K2 > 0) {
    back_index_kernel<<<(B * K2 + 255) / 256, 256, 0, st>>>(key, B * K2,
                                                            static_cast<int*>(back));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_match_epilogue(const void* best_j, const void* d_best, const void* d_second,
                               const void* v1, const void* back, int B, int K1, int K2,
                               float ratio2, void* score, void* stream) {
  if (B * K1 > 0) {
    match_epilogue_kernel<<<(B * K1 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(best_j), static_cast<const float*>(d_best),
        static_cast<const float*>(d_second), static_cast<const uint8_t*>(v1),
        static_cast<const int*>(back), B, K1, K2, ratio2, static_cast<float*>(score));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_match_compact(const void* top, const void* order, const void* best_j, int B,
                              int K1, int k, int M, void* idx1, void* idx2, void* valid,
                              void* dist, void* stream) {
  if (B * M > 0) {
    match_compact_kernel<<<(B * M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(top), static_cast<const int64_t*>(order),
        static_cast<const int*>(best_j), B, K1, k, M, static_cast<int64_t*>(idx1),
        static_cast<int64_t*>(idx2), static_cast<uint8_t*>(valid), static_cast<float*>(dist));
  }
  return static_cast<int>(cudaGetLastError());
}
