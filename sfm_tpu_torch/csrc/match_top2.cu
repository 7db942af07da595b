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
// Design (simple first): one block per (pair, 64 query rows); 256 threads in a
// 16 x 16 grid, each owning a 4 x 4 register tile of dot products (rows ty+16i,
// columns tx+16j). 64-column tiles of the other set stream through shared memory
// in depth stages of 32 floats (the query tile is re-staged with them). After a
// column tile, each thread folds its 16 distances into a running top-2 per row;
// the 16 lanes that share a row merge theirs with warp shuffles at the end.
//
// Semantics (the plain twin's, i.e. jnp.min/argmin): d = max(2 - 2 a.b, 0), +inf
// for an invalid column and for every column of an invalid row; ties go to the
// lowest column index; an all-inf row returns index 0; "second" is the minimum
// over every column but the best one (equal to best on a tie).
#include <climits>

#include "sfm_common.cuh"

namespace {

constexpr int TR = 64;   // query rows per block
constexpr int TC = 64;   // candidate columns per tile
constexpr int TK = 32;   // depth per shared-memory stage
constexpr int NT = 256;  // threads: 16 x 16, 4 x 4 outputs each

struct Top2 {
  float best;
  int idx;
  float second;
};

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

__global__ void __launch_bounds__(NT) match_top2_kernel(
    const float* __restrict__ d1, const uint8_t* __restrict__ v1,
    const float* __restrict__ d2, const uint8_t* __restrict__ v2,
    int K1, int K2, int D,
    int* __restrict__ out_idx, float* __restrict__ out_best,
    float* __restrict__ out_second) {
  __shared__ float As[TK][TR + 1];  // depth-major: As[k][row]
  __shared__ float Bs[TK][TC + 1];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float* A = d1 + (size_t)b * K1 * D;
  const float* Bm = d2 + (size_t)b * K2 * D;
  const uint8_t* vcol = v2 + (size_t)b * K2;

  Top2 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = Top2{INFINITY, INT_MAX, INFINITY};

  for (int c0 = 0; c0 < K2; c0 += TC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += TK) {
      for (int e = threadIdx.x; e < TR * TK; e += NT) {
        const int r = e / TK, k = e % TK, gr = r0 + r;
        As[k][r] = gr < K1 ? A[(size_t)gr * D + k0 + k] : 0.f;
      }
      for (int e = threadIdx.x; e < TC * TK; e += NT) {
        const int c = e / TK, k = e % TK, gc = c0 + c;
        Bs[k][c] = gc < K2 ? Bm[(size_t)gc * D + k0 + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {  // increasing column order
      const int gc = c0 + tx + 16 * j;
      if (gc >= K2) continue;
      const bool col_ok = vcol[gc] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = col_ok ? fmaxf(2.f - 2.f * acc[i][j], 0.f) : INFINITY;
        top2_push(top[i], d, gc);
      }
    }
  }

  // The 16 lanes tx = 0..15 of a half-warp share rows ty + 16i: merge them.
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
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
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
