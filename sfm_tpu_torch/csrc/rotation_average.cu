// Kernel K13-b: rotation averaging, one solve per launch.
//
// Replaces global_init.py::rotation_averaging's device program `_solve`
// (:438-510): the spectral init (48 steps of X <- D^-1 G X + X on the
// (3N, 3) stack, each followed by the closed-form Gram-Schmidt of its three
// columns), the Davenport q-method projection of every 3x3 block onto SO(3)
// (nearest_rotation: 24 power steps from the arg-max-diagonal start), then 10
// rounds of Lie-algebra IRLS: per pair the residual log(R_j^T R_ij R_i),
// Huber at delta = max(0.3 0.6^k, 0.02), 32 CG steps on the weighted graph
// Laplacian + 1e-6 I, and the second-order exp projected back by
// nearest_rotation. XLA scatters a dense (3N, 3N) G and (N, N) L and
// multiplies; here both are passes over each camera's incident pairs
// (graph_avg.cuh), the same sums in another order.
//
// Design: one block of 256 threads for the whole solve (a camera or a pair a
// thread, looping); the stack X (later the rotations) and the CG vectors
// (25 N floats) live in shared memory up to N = 1024 (100 KB), above it in a
// global scratch the caller gives (`state`): one templated body, so the two
// storages run the same arithmetic in the same order and N <= 1024 keeps
// its bits. Per-pair residuals and weights, and the incidence lists, are in
// global scratch. Every reduction is a deterministic block sum.
//
// What bounds it on the H100: latency. ~370 dependent passes over the pair
// list (48 power steps with 5 Gram-Schmidt reductions each, 10 x 32 CG steps
// with 2 each); at N = 150 and P = 1,102 a pass is ~40k FLOP. One SM works;
// the rest of the card idles.
#include "graph_avg.cuh"

namespace {

using namespace sfm_avg;

constexpr int kMaxN = 1024;  // cameras whose state fits in shared memory

// global_init.py::nearest_rotation of a row-major 3x3 (Davenport q-method).
__device__ void nearest_rotation(const float* A, float* R) {
  const float a11 = A[0], a12 = A[1], a13 = A[2];
  const float a21 = A[3], a22 = A[4], a23 = A[5];
  const float a31 = A[6], a32 = A[7], a33 = A[8];
  const float B[4][4] = {
      {a11 + a22 + a33, a32 - a23, a13 - a31, a21 - a12},
      {a32 - a23, a11 - a22 - a33, a12 + a21, a13 + a31},
      {a13 - a31, a12 + a21, a22 - a11 - a33, a23 + a32},
      {a21 - a12, a13 + a31, a23 + a32, a33 - a11 - a22}};
  float fro = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) fro += A[k] * A[k];
  const float c = sqrtf(fro) * 2.f + 1e-6f;
  int im = 0;  // jnp.argmax: the first maximum
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (B[k][k] > B[im][im]) im = k;
  float q[4] = {0.f, 0.f, 0.f, 0.f};
  q[im] = 1.f;
  for (int it = 0; it < 24; ++it) {
    float y[4], n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = B[i][0] * q[0] + B[i][1] * q[1] + B[i][2] * q[2] + B[i][3] * q[3] + c * q[i];
      n2 += y[i] * y[i];
    }
    const float nrm = fmaxf(sqrtf(n2), kEps);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = y[i] / nrm;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

// global_init.py::_log_so3 (branchless small/large angle).
__device__ __forceinline__ void log_so3(const float* R, float* v) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_t = fminf(fmaxf((tr - 1.f) * 0.5f, -1.f), 1.f);
  const float theta = acosf(cos_t);
  const float sin_t = fmaxf(sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f)), kEps);
  const float scale = theta < 1e-4f ? 0.5f + theta * theta / 12.f : theta / (2.f * sin_t);
  v[0] = (R[7] - R[5]) * scale;
  v[1] = (R[2] - R[6]) * scale;
  v[2] = (R[3] - R[1]) * scale;
}

struct Edges {
  const int* pairs;
  const float* R;  // (P, 9) R_ij
  const float* w;  // (P,) normalized weights
};

template <bool kShared>
__global__ void __launch_bounds__(NT) rotation_average_kernel(
    Edges g, int P, int N, int power_iters, int refine_iters, const float* __restrict__ X0,
    int* __restrict__ off, int* __restrict__ adj, float* __restrict__ res,
    float* __restrict__ state, float* __restrict__ R_out) {
  extern __shared__ float smem[];
  float* X = kShared ? smem : state;  // 9N: the (3N, 3) stack, later the rotations
  float* T = X + 9 * N;          // 15N: G X during the power steps, then CG's vectors
  float* dinv = T + 15 * N;      // N
  __shared__ float red[NT / 32][1];

  build_incidence(g.pairs, P, N, off, adj);
  for (int k = threadIdx.x; k < 9 * N; k += NT) X[k] = X0[k];
  for (int n = threadIdx.x; n < N; n += NT) {
    float deg = 0.f;
    for (int a = off[n]; a < off[n + 1]; ++a) deg += g.w[adj[a] >> 1];
    dinv[n] = 1.f / fmaxf(deg, 1.f);
  }
  __syncthreads();

  // ---- spectral init: X <- D^-1 G X + X, then Gram-Schmidt of its columns.
  // G's block (i, j) is w R_ij^T and (j, i) its transpose w R_ij.
  for (int it = 0; it < power_iters; ++it) {
    for (int n = threadIdx.x; n < N; n += NT) {
      float y[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int a = off[n]; a < off[n + 1]; ++a) {
        const int e = adj[a] >> 1, side = adj[a] & 1;
        const float* Re = g.R + (size_t)e * 9;
        const float* Xo = X + 9 * g.pairs[2 * e + (1 - side)];
        const float we = g.w[e];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              s += (side == 0 ? Re[k * 3 + r] : Re[r * 3 + k]) * we * Xo[k * 3 + c];
            y[r * 3 + c] += s;
          }
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) T[9 * n + k] = y[k] * dinv[n];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < 9 * N; k += NT) X[k] = T[k] + X[k];
    __syncthreads();
    // _gram_schmidt3 on the columns of the (3N, 3) stack (rows q = 3n + r).
    const int M = 3 * N;
    float s = 0.f;
    for (int q = threadIdx.x; q < M; q += NT) s += X[3 * q] * X[3 * q];
    const float n0 = fmaxf(sqrtf(block_total(s, red)), kEps);
    float s1 = 0.f, s2 = 0.f;
    for (int q = threadIdx.x; q < M; q += NT) {
      X[3 * q] /= n0;
      s1 += X[3 * q] * X[3 * q + 1];
      s2 += X[3 * q] * X[3 * q + 2];
    }
    const float d01 = block_total(s1, red), d02 = block_total(s2, red);
    s = 0.f;
    for (int q = threadIdx.x; q < M; q += NT) {
      T[q] = X[3 * q + 1] - d01 * X[3 * q];  // c1 before its norm
      s += T[q] * T[q];
    }
    const float n1 = fmaxf(sqrtf(block_total(s, red)), kEps);
    s = 0.f;
    for (int q = threadIdx.x; q < M; q += NT) {
      T[q] /= n1;
      s += T[q] * X[3 * q + 2];
    }
    const float d12 = block_total(s, red);
    s = 0.f;
    for (int q = threadIdx.x; q < M; q += NT) {
      const float c2 = X[3 * q + 2] - d02 * X[3 * q] - d12 * T[q];
      X[3 * q + 1] = T[q];
      X[3 * q + 2] = c2;
      s += c2 * c2;
    }
    const float n2 = fmaxf(sqrtf(block_total(s, red)), kEps);
    for (int q = threadIdx.x; q < M; q += NT) X[3 * q + 2] /= n2;
    __syncthreads();
  }
  for (int n = threadIdx.x; n < N; n += NT) {
    float Rn[9];
    nearest_rotation(X + 9 * n, Rn);
#pragma unroll
    for (int k = 0; k < 9; ++k) X[9 * n + k] = Rn[k];
  }
  __syncthreads();

  // ---- Lie-algebra IRLS with annealed Huber.
  float* xv = T;           // 3N each
  float* rv = T + 3 * N;
  float* pv = T + 6 * N;
  float* Ap = T + 9 * N;
  float* bv = T + 12 * N;
  float* wp = res + 3 * (size_t)P;  // res: (P, 3) residuals, then (P,) weights
  for (int k = 0; k < refine_iters; ++k) {
    const float delta = (float)fmax(0.3 * pow(0.6, (double)k), 0.02);
    for (int e = threadIdx.x; e < P; e += NT) {
      const float* Ri = X + 9 * g.pairs[2 * e];
      const float* Rj = X + 9 * g.pairs[2 * e + 1];
      const float* Rr = g.R + (size_t)e * 9;
      float M[9], E[9];  // M = R_ij R_i; E = R_j^T M
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int d = 0; d < 3; ++d)
          M[b * 3 + d] = Rr[b * 3] * Ri[d] + Rr[b * 3 + 1] * Ri[3 + d] + Rr[b * 3 + 2] * Ri[6 + d];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int d = 0; d < 3; ++d)
          E[a * 3 + d] = Rj[a] * M[d] + Rj[3 + a] * M[3 + d] + Rj[6 + a] * M[6 + d];
      float r[3];
      log_so3(E, r);
      const float rn = sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
      const float huber = rn > delta ? delta / fmaxf(rn, kEps) : 1.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) res[3 * (size_t)e + c] = r[c];
      wp[e] = g.w[e] * huber;
    }
    __syncthreads();
    // b: + wp r at j, - wp r at i.
    for (int n = threadIdx.x; n < N; n += NT) {
      float b3[3] = {0.f, 0.f, 0.f};
      for (int a = off[n]; a < off[n + 1]; ++a) {
        const int e = adj[a] >> 1;
        const float s = (adj[a] & 1) ? wp[e] : -wp[e];
#pragma unroll
        for (int c = 0; c < 3; ++c) b3[c] += s * res[3 * (size_t)e + c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) bv[3 * n + c] = b3[c];
    }
    __syncthreads();
    // (L + 1e-6 I) x: sum over incident pairs of wp (x_n - x_other).
    auto laplacian = [&](const float* in, float* out) {
      for (int n = threadIdx.x; n < N; n += NT) {
        float y[3] = {1e-6f * in[3 * n], 1e-6f * in[3 * n + 1], 1e-6f * in[3 * n + 2]};
        for (int a = off[n]; a < off[n + 1]; ++a) {
          const int e = adj[a] >> 1;
          const int o = g.pairs[2 * e + 1 - (adj[a] & 1)];
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] += wp[e] * (in[3 * n + c] - in[3 * o + c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) out[3 * n + c] = y[c];
      }
      __syncthreads();
    };
    block_cg(laplacian, bv, xv, rv, pv, Ap, 3 * N, 32, false, red);
    // R_n <- R_n nearest_rotation(I + S + S^2 / 2), S = [d_n]x.
    for (int n = threadIdx.x; n < N; n += NT) {
      const float dx = xv[3 * n], dy = xv[3 * n + 1], dz = xv[3 * n + 2];
      const float S[9] = {0.f, -dz, dy, dz, 0.f, -dx, -dy, dx, 0.f};
      float A[9], dR[9], Rn[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float S2 = S[i * 3] * S[j] + S[i * 3 + 1] * S[3 + j] + S[i * 3 + 2] * S[6 + j];
          A[i * 3 + j] = (i == j ? 1.f : 0.f) + S[i * 3 + j] + 0.5f * S2;
        }
      nearest_rotation(A, dR);
      const float* R = X + 9 * n;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Rn[i * 3 + j] = R[i * 3] * dR[j] + R[i * 3 + 1] * dR[3 + j] + R[i * 3 + 2] * dR[6 + j];
#pragma unroll
      for (int q = 0; q < 9; ++q) X[9 * n + q] = Rn[q];
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < 9 * N; k += NT) R_out[k] = X[k];
}

}  // namespace

SFM_API int sfm_rotation_average(const void* pairs, const void* R_rel, const void* w,
                                 const void* X0, int P, int N, int power_iters,
                                 int refine_iters, void* off, void* adj, void* res,
                                 void* state, void* R, void* stream) {
  // state: nullptr (N <= kMaxN, the solve's vectors in shared memory) or 25 N
  // floats of global scratch (any N).
  if (N < 1 || (state == nullptr && N > kMaxN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Edges g{static_cast<const int*>(pairs), static_cast<const float*>(R_rel),
                static_cast<const float*>(w)};
#define ROTATION_AVERAGE_ARGS                                                                \
  g, P, N, power_iters, refine_iters, static_cast<const float*>(X0), static_cast<int*>(off), \
      static_cast<int*>(adj), static_cast<float*>(res), static_cast<float*>(state),          \
      static_cast<float*>(R)
  if (state == nullptr) {
    const size_t smem = (size_t)25 * N * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(rotation_average_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    rotation_average_kernel<true><<<1, NT, smem, st>>>(ROTATION_AVERAGE_ARGS);
  } else {
    rotation_average_kernel<false><<<1, NT, 0, st>>>(ROTATION_AVERAGE_ARGS);
  }
#undef ROTATION_AVERAGE_ARGS
  return static_cast<int>(cudaGetLastError());
}
