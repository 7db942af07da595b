// Pieces shared by K13-b (rotation_average.cu) and K13-c
// (translation_average.cu): the pair graph's per-camera incidence lists, a
// deterministic block dot product, and global_init.py::_cg as a loop inside
// one block.
//
// The reference scatters the pair list into a dense (3N, 3N) or (N, N) matrix
// and multiplies (a TPU idiom: the MXU likes dense products). Here each
// operator is applied as a pass over every camera's incident pairs: the same
// sums in another order. A camera's list holds its pairs in pair order,
// built by the block itself, so every sum has a fixed order and a solve is
// repeatable.
#pragma once

#include "sfm_common.cuh"

namespace sfm_avg {

constexpr int NT = 256;
constexpr float kEps = 1e-12f;  // global_init.py::_EPS

// Incidence lists: for camera n, entries adj[off[n] .. off[n+1]) are
// 2 e + side, side 0 when n is pairs[e, 0] (i) and 1 when it is pairs[e, 1]
// (j), in increasing pair order. off holds N + 1 ints, adj 2 P. Every thread
// of the block must call it; the lists are visible when it returns.
__device__ inline void build_incidence(const int* __restrict__ pairs, int P, int N,
                                       int* __restrict__ off, int* __restrict__ adj) {
  for (int n = threadIdx.x; n < N; n += NT) {
    int c = 0;
    for (int e = 0; e < P; ++e) c += (pairs[2 * e] == n) + (pairs[2 * e + 1] == n);
    off[n + 1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int n = 0; n < N; ++n) off[n + 1] += off[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += NT) {
    int k = off[n];
    for (int e = 0; e < P; ++e) {
      if (pairs[2 * e] == n) adj[k++] = 2 * e;
      if (pairs[2 * e + 1] == n) adj[k++] = 2 * e + 1;
    }
  }
  __syncthreads();
}

// Sum over i < n of a[i] b[i] (jnp.sum(a * b)), the same in every thread.
__device__ __forceinline__ float block_dot(const float* a, const float* b, int n,
                                           float (*red)[1]) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += NT) s += a[i] * b[i];
  sfm_block_sum<NT, 1>(&s, red);
  return s;
}

// Sum over i < n of v[i] (one value a thread), the same in every thread.
__device__ __forceinline__ float block_total(float v, float (*red)[1]) {
  sfm_block_sum<NT, 1>(&v, red);
  return v;
}

// global_init.py::_cg: `iters` conjugate-gradient steps on A x = b over n
// entries (n = 3N: the three right-hand sides of (N, 3) share the scalars, as
// the reference's sums run over the whole (N, 3) array). op(in, out) applies A
// to all cameras and ends in a barrier. With warm, x holds x0 and r = b - A x0.
// Every thread of the block must call it.
template <class Op>
__device__ void block_cg(const Op& op, const float* b, float* x, float* r, float* p, float* Ap,
                         int n, int iters, bool warm, float (*red)[1]) {
  if (warm) {
    op(x, Ap);
    for (int i = threadIdx.x; i < n; i += NT) r[i] = b[i] - Ap[i];
  } else {
    for (int i = threadIdx.x; i < n; i += NT) {
      x[i] = 0.f;
      r[i] = b[i];
    }
  }
  for (int i = threadIdx.x; i < n; i += NT) p[i] = r[i];
  float rs = block_dot(r, r, n, red);  // its barriers publish p
  for (int it = 0; it < iters; ++it) {
    op(p, Ap);
    const float alpha = rs / fmaxf(block_dot(p, Ap, n, red), kEps);
    for (int i = threadIdx.x; i < n; i += NT) {
      x[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
    }
    const float rs_new = block_dot(r, r, n, red);
    const float beta = rs_new / fmaxf(rs, kEps);
    for (int i = threadIdx.x; i < n; i += NT) p[i] = r[i] + beta * p[i];
    __syncthreads();
    rs = rs_new;
  }
}

// x <- x - mean over cameras (jnp.mean(C, axis=0)), in place.
__device__ inline void center(float* x, int N, float (*red)[1]) {
  for (int c = 0; c < 3; ++c) {
    float s = 0.f;
    for (int n = threadIdx.x; n < N; n += NT) s += x[3 * n + c];
    const float m = block_total(s, red) / (float)N;
    for (int n = threadIdx.x; n < N; n += NT) x[3 * n + c] -= m;
    __syncthreads();
  }
}

}  // namespace sfm_avg
