// The descriptor-distance tile shared by K1 (match_top2.cu), K1-r
// (retrieval_score.cu) and K1-g (guided_match.cu).
//
// A block of 256 threads in a 16 x 16 grid computes a 64 x 64 tile of dot
// products between rows r0.. of A (n_a x D) and rows c0.. of B (n_b x D); each
// thread owns a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j). Depth
// stages of 32 floats of both sides go through shared memory. Rows past n_a or
// columns past n_b read zeros; callers mask them.
#pragma once

#include <climits>

#include "cp_async.cuh"
#include "sfm_common.cuh"

namespace sfm_tile {

constexpr int TR = 64;   // rows per tile
constexpr int TC = 64;   // columns per tile
constexpr int TK = 32;   // depth per shared-memory stage
constexpr int NT = 256;  // threads: 16 x 16, 4 x 4 outputs each

struct Stage {
  float A[TK][TR + 1];  // depth-major: A[k][row]
  float B[TK][TC + 1];
};

__device__ __forceinline__ int tx() { return threadIdx.x % 16; }
__device__ __forceinline__ int ty() { return threadIdx.x / 16; }

// acc[i][j] = A[r0 + ty + 16 i] . B[c0 + tx + 16 j]. Every thread of the
// block must call it; it synchronizes before it returns.
__device__ __forceinline__ void dots(Stage& s, const float* __restrict__ A, int n_a,
                                     int r0, const float* __restrict__ B, int n_b,
                                     int c0, int D, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += TK) {
    for (int e = threadIdx.x; e < TR * TK; e += NT) {
      const int r = e / TK, k = e % TK, gr = r0 + r;
      s.A[k][r] = gr < n_a ? A[(size_t)gr * D + k0 + k] : 0.f;
    }
    for (int e = threadIdx.x; e < TC * TK; e += NT) {
      const int c = e / TK, k = e % TK, gc = c0 + c;
      s.B[k][c] = gc < n_b ? B[(size_t)gc * D + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.A[k][ty() + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.B[k][tx() + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The matcher's distance, max(2 - 2 a.b, 0), or +inf when either side is masked.
__device__ __forceinline__ float distance(float dot, bool ok) {
  return ok ? fmaxf(2.f - 2.f * dot, 0.f) : INFINITY;
}

// Running top-2 of one row: lexicographic (distance, index) best, and the
// minimum over every other column. Any merge order gives jnp.argmin's ties.
struct Top2 {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ Top2 top2_empty() { return Top2{INFINITY, INT_MAX, INFINITY}; }

__device__ __forceinline__ void top2_push(Top2& t, float d, int j) {
  if (d < t.best || (d == t.best && j < t.idx)) {
    t.second = t.best;
    t.best = d;
    t.idx = j;
  } else if (d < t.second) {
    t.second = d;
  }
}

__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  const bool b_wins = b.best < a.best || (b.best == a.best && b.idx < a.idx);
  const Top2& w = b_wins ? b : a;
  const Top2& l = b_wins ? a : b;
  return Top2{w.best, w.idx, fminf(w.second, l.best)};
}

// Merge the 16 lanes tx = 0..15 of each half-warp, which share rows ty + 16 i.
__device__ __forceinline__ void top2_merge_lanes(Top2 top[4]) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Top2 o;
      o.best = __shfl_xor_sync(0xffffffffu, top[i].best, off);
      o.idx = __shfl_xor_sync(0xffffffffu, top[i].idx, off);
      o.second = __shfl_xor_sync(0xffffffffu, top[i].second, off);
      top[i] = top2_merge(top[i], o);
    }
  }
}

// ---- Shared by the resident-rows designs (match_top2.cu, retrieval_score.cu) --

// A column's (distance, row) as one u64 (float bits << 32 | row): distances are
// >= 0 or +inf, so the keys order as (distance, row), and their minimum is
// jnp.argmin's lowest-row tie.
constexpr unsigned long long kKeyMax = ~0ull;

__device__ __forceinline__ unsigned long long col_key(float d, int row) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)row;
}

// top2_push for a thread whose columns come in increasing order: a tie never
// goes to the new column, so the push needs no branch. A row whose every
// distance is +inf keeps idx INT_MAX (top2_push would take its first column).
__device__ __forceinline__ void top2_push_ascending(Top2& t, float d, int j) {
  const bool nb = d < t.best;
  t.second = nb ? t.best : fminf(t.second, d);
  t.idx = nb ? j : t.idx;
  t.best = nb ? d : t.best;
}

}  // namespace sfm_tile
