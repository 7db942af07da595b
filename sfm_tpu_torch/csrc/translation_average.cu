// Kernel K13-c: translation averaging, one solve per launch.
//
// Replaces global_init.py::translation_averaging's device program `_solve`
// (:598-672). With d_p the unit baseline direction of pair p (C_j - C_i) and
// w its weight:
//  1. the ridge-sign solve: `als_rounds` rounds of (M + eps I) C = q by 80 CG
//     steps from 0, M = sum_p w_p blocks of (I - d d^T) on the pair's Laplacian
//     pattern, q = sum_p w_p (d at j, -d at i), eps = 1e-3 tr(M) / (3N) + 1e-8;
//     after the first round the weights are the residual weights (Huber on the
//     angular residual at 0.05, and 1e-2 on a pair whose projection on the
//     current layout is negative); each solution is centred;
//  2. with an initial layout: the score sum w (1 - cos) / sum w of both, the
//     ridge solution kept when it scores no worse;
//  3. `als_rounds` scale-explicit rounds: per pair the baseline length
//     s_p = max(|proj|, 0.05 mean |proj|), then 80 CG steps on the weighted
//     Laplacian + 1e-6 I against sum_p w_p s_p d_p, warm-started at the current
//     layout, which is centred after each round.
// XLA scatters a dense (3N, 3N) M and (N, N) L and multiplies; here both are
// passes over each camera's incident pairs (graph_avg.cuh), the same sums in
// another order. The median-baseline scale gauge stays on the host.
//
// Design: one block of 256 threads for the whole solve; the layouts and the
// CG vectors (21 N floats) in shared memory up to N = 1024 (84 KB), above it
// in a global scratch the caller gives (`state`): one templated body, the same
// arithmetic in the same order either way; per-pair weights and projections,
// and the incidence lists, in global scratch.
//
// What bounds it on the H100: latency. Up to 6 x 80 dependent CG steps, two
// block reductions each; at N = 150 and P = 1,102 a pass is ~30k FLOP. One
// SM works.
#include "graph_avg.cuh"

namespace {

using namespace sfm_avg;

constexpr int kMaxN = 1024;  // cameras whose state fits in shared memory

struct Graph {
  const int* pairs;
  const float* d;  // (P, 3) unit baseline directions
  const float* w;  // (P,) normalized weights
  const int* off;
  const int* adj;
  int P, N;
};

// Residual weights and projections of the layout C (global_init.py
// residual_weights), written per pair.
__device__ void residual_weights(const Graph& g, const float* C, float* wp, float* proj) {
  for (int e = threadIdx.x; e < g.P; e += NT) {
    const int i = g.pairs[2 * e], j = g.pairs[2 * e + 1];
    const float* d = g.d + 3 * (size_t)e;
    float base[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) base[c] = C[3 * j + c] - C[3 * i + c];
    const float bn = fmaxf(sqrtf(base[0] * base[0] + base[1] * base[1] + base[2] * base[2]), kEps);
    const float pr = base[0] * d[0] + base[1] * d[1] + base[2] * d[2];
    float q[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = base[c] - pr * d[c];
    const float sin_res = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]) / bn;
    float we = g.w[e] * (sin_res > 0.05f ? 0.05f / sin_res : 1.f);
    if (pr < 0.f) we *= 1e-2f;
    wp[e] = we;
    proj[e] = pr;
  }
  __syncthreads();
}

// sum_p w_p (1 - cos(C_j - C_i, d_p)) / max(sum_p w_p, eps).
__device__ float score(const Graph& g, const float* C, float (*red)[1]) {
  float num = 0.f, den = 0.f;
  for (int e = threadIdx.x; e < g.P; e += NT) {
    const int i = g.pairs[2 * e], j = g.pairs[2 * e + 1];
    const float* d = g.d + 3 * (size_t)e;
    float base[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) base[c] = C[3 * j + c] - C[3 * i + c];
    const float bn = fmaxf(sqrtf(base[0] * base[0] + base[1] * base[1] + base[2] * base[2]), kEps);
    const float cs = (base[0] * d[0] + base[1] * d[1] + base[2] * d[2]) / bn;
    num += g.w[e] * (1.f - cs);
    den += g.w[e];
  }
  num = block_total(num, red);
  den = block_total(den, red);
  return num / fmaxf(den, kEps);
}

// out_n = sum over incident pairs of s_p v_p (+ at j, - at i).
__device__ void pair_rhs(const Graph& g, const float* wp, const float* scale, float* out) {
  for (int n = threadIdx.x; n < g.N; n += NT) {
    float b[3] = {0.f, 0.f, 0.f};
    for (int a = g.off[n]; a < g.off[n + 1]; ++a) {
      const int e = g.adj[a] >> 1;
      float s = wp[e] * (scale != nullptr ? scale[e] : 1.f);
      if (!(g.adj[a] & 1)) s = -s;
#pragma unroll
      for (int c = 0; c < 3; ++c) b[c] += s * g.d[3 * (size_t)e + c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * n + c] = b[c];
  }
  __syncthreads();
}

template <bool kShared>
__global__ void __launch_bounds__(NT) translation_average_kernel(
    const int* __restrict__ pairs, const float* __restrict__ dirs, const float* __restrict__ w,
    const float* __restrict__ C_init, int P, int N, int rounds, int cg_iters, int has_init,
    int* __restrict__ off, int* __restrict__ adj, float* __restrict__ scratch,
    float* __restrict__ state, float* __restrict__ C_out) {
  extern __shared__ float smem[];
  float* C = kShared ? smem : state;  // 3N: the init, later the ALS layout
  float* Cr = C + 3 * N;   // 3N: the ridge solution
  float* bv = Cr + 3 * N;  // 3N each: CG's right-hand side and vectors
  float* rv = bv + 3 * N;
  float* pv = rv + 3 * N;
  float* Ap = pv + 3 * N;
  float* xv = Ap + 3 * N;
  __shared__ float red[NT / 32][1];
  float* wp = scratch;        // (P,)
  float* proj = scratch + P;  // (P,), later the baseline lengths

  build_incidence(pairs, P, N, off, adj);
  const Graph g{pairs, dirs, w, off, adj, P, N};
  for (int k = threadIdx.x; k < 3 * N; k += NT) {
    C[k] = C_init[k];
    Cr[k] = 0.f * C_init[k];  // C * 0.0
  }
  for (int e = threadIdx.x; e < P; e += NT) wp[e] = w[e];
  __syncthreads();

  // 1. The ridge-sign solve.
  float eps = 0.f;
  auto ridge = [&](const float* in, float* out) {
    for (int n = threadIdx.x; n < N; n += NT) {
      float y[3] = {eps * in[3 * n], eps * in[3 * n + 1], eps * in[3 * n + 2]};
      for (int a = off[n]; a < off[n + 1]; ++a) {
        const int e = adj[a] >> 1;
        const int o = pairs[2 * e + 1 - (adj[a] & 1)];
        const float* d = dirs + 3 * (size_t)e;
        float v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = in[3 * n + c] - in[3 * o + c];
        const float dv = d[0] * v[0] + d[1] * v[1] + d[2] * v[2];
#pragma unroll
        for (int c = 0; c < 3; ++c) y[c] += wp[e] * (v[c] - d[c] * dv);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * n + c] = y[c];
    }
    __syncthreads();
  };
  for (int k = 0; k < max(rounds, 1); ++k) {
    if (k > 0) residual_weights(g, Cr, wp, proj);
    float tr = 0.f;  // tr(M) = sum_p 2 w_p tr(I - d d^T)
    for (int e = threadIdx.x; e < P; e += NT) {
      const float* d = dirs + 3 * (size_t)e;
      tr += 2.f * wp[e] * ((1.f - d[0] * d[0]) + (1.f - d[1] * d[1]) + (1.f - d[2] * d[2]));
    }
    eps = 1e-3f * block_total(tr, red) / (float)(3 * N) + 1e-8f;
    pair_rhs(g, wp, nullptr, bv);
    block_cg(ridge, bv, xv, rv, pv, Ap, 3 * N, cg_iters, false, red);
    for (int q = threadIdx.x; q < 3 * N; q += NT) Cr[q] = xv[q];
    __syncthreads();
    center(Cr, N, red);
  }

  if (has_init) {
    // 2. The better of the ridge solution and the init (ties to the ridge).
    const bool ridge_wins = score(g, Cr, red) <= score(g, C, red);
    if (ridge_wins)
      for (int q = threadIdx.x; q < 3 * N; q += NT) C[q] = Cr[q];
    __syncthreads();
    // 3. Scale-explicit ALS rounds around the winner.
    auto laplacian = [&](const float* in, float* out) {
      for (int n = threadIdx.x; n < N; n += NT) {
        float y[3] = {1e-6f * in[3 * n], 1e-6f * in[3 * n + 1], 1e-6f * in[3 * n + 2]};
        for (int a = off[n]; a < off[n + 1]; ++a) {
          const int e = adj[a] >> 1;
          const int o = pairs[2 * e + 1 - (adj[a] & 1)];
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] += wp[e] * (in[3 * n + c] - in[3 * o + c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) out[3 * n + c] = y[c];
      }
      __syncthreads();
    };
    for (int k = 0; k < max(rounds, 1); ++k) {
      residual_weights(g, C, wp, proj);
      float s = 0.f;
      for (int e = threadIdx.x; e < P; e += NT) s += fabsf(proj[e]);
      const float floor_ = 0.05f * (block_total(s, red) / (float)P);
      for (int e = threadIdx.x; e < P; e += NT) proj[e] = fmaxf(fabsf(proj[e]), floor_);
      __syncthreads();
      pair_rhs(g, wp, proj, bv);
      for (int q = threadIdx.x; q < 3 * N; q += NT) xv[q] = C[q];
      __syncthreads();
      block_cg(laplacian, bv, xv, rv, pv, Ap, 3 * N, cg_iters, true, red);
      for (int q = threadIdx.x; q < 3 * N; q += NT) C[q] = xv[q];
      __syncthreads();
      center(C, N, red);
    }
  } else {
    for (int q = threadIdx.x; q < 3 * N; q += NT) C[q] = Cr[q];
    __syncthreads();
  }
  for (int q = threadIdx.x; q < 3 * N; q += NT) C_out[q] = C[q];
}

}  // namespace

SFM_API int sfm_translation_average(const void* pairs, const void* d, const void* w,
                                    const void* C_init, int P, int N, int rounds, int cg_iters,
                                    int has_init, void* off, void* adj, void* scratch,
                                    void* state, void* C, void* stream) {
  // state: nullptr (N <= kMaxN, the solve's vectors in shared memory) or 21 N
  // floats of global scratch (any N).
  if (N < 1 || P < 1 || (state == nullptr && N > kMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRANSLATION_AVERAGE_ARGS                                                             \
  static_cast<const int*>(pairs), static_cast<const float*>(d), static_cast<const float*>(w), \
      static_cast<const float*>(C_init), P, N, rounds, cg_iters, has_init,                   \
      static_cast<int*>(off), static_cast<int*>(adj), static_cast<float*>(scratch),          \
      static_cast<float*>(state), static_cast<float*>(C)
  if (state == nullptr) {
    const size_t smem = (size_t)21 * N * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(translation_average_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    translation_average_kernel<true><<<1, NT, smem, st>>>(TRANSLATION_AVERAGE_ARGS);
  } else {
    translation_average_kernel<false><<<1, NT, 0, st>>>(TRANSLATION_AVERAGE_ARGS);
  }
#undef TRANSLATION_AVERAGE_ARGS
  return static_cast<int>(cudaGetLastError());
}
