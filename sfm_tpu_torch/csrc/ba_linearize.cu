// Kernel K8+K9: BA residuals, analytic Jacobians, Huber whitening and the
// lambda-independent reductions of the LM normal equations; plus the Huber cost.
//
// Replaces sfm_tpu/ba/residuals.py::residuals_and_jacobians (:68, vmapped
// jax.jacrev of residual_one in 131k-row chunks) and ba/schur.py::
// linearize_system (:119, whitening + segment sums into V, g_p, U, g_c, Uk,
// g_k), which XLA ran as separate passes over (O, 2, 13) Jacobian tensors.
//
// sfm_ba_linearize launches two kernels:
//  1. one thread per observation row (grid-stride): Rodrigues with the
//     theta^2 < 1e-8 Taylor branch of rotations.py::rodrigues, the projection
//     with shared intrinsics, the residual, the analytic Jacobians (the
//     derivative of that same branch, so rvec = 0 -- the seed camera -- gives
//     finite values), the Huber weight and the whitening
//     sqrt(w * obs_w) * cam_free (camera) / * point_valid (point). It writes
//     the whitened Jc, Jk, Jp, rw (read by K10 and the back-substitution) and
//     reduces the camera side (U, g_c) and the intrinsics (Uk, g_k). Few
//     cameras, many observations: each block accumulates into its own copy
//     in shared memory (42 floats a camera) and flushes it with one global
//     atomic per nonzero entry; Uk/g_k are warp-reduced first.
//  2. one thread per row of the per-point grouping (schur.py::coobs_pairs):
//     V and g_p as a plain loop over the point's observations, no atomics.
// Dead rows (obs_w == 0) write zeros and skip all arithmetic.
// sfm_ba_cost: the Huber cost of every row with obs_w > 0 (the LM accept
// test), each block's sum added once into an f64 accumulator.
//
// What bounds it on the H100: ~400 FLOP per observation (200k rows: 80 MFLOP)
// and ~140 bytes written per row (28 MB); both are microseconds, so launch
// and the shared-memory flush dominate at the main path's sizes.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;

struct Obs {
  float r[2];
  float Jc[2][6];
  float Jk[2][4];
  float Jp[2][3];
};

// Residual and Jacobians of one observation (unwhitened). with_jac = false
// computes the residual alone.
template <bool with_jac>
__device__ __forceinline__ void residual_jac(const float* w, const float* t,
                                             const float* intr, const float* X,
                                             float x, float y, Obs* o) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float a, b, da, db;  // R = I + a K + b K^2; da, db = d/d(theta^2)
  if (th2 < 1e-8f) {
    a = 1.f - th2 / 6.f;
    b = 0.5f - th2 / 24.f;
    da = -1.f / 6.f;
    db = -1.f / 24.f;
  } else {
    const float th = sqrtf(th2);
    const float s = sinf(th), c = cosf(th);
    a = s / th;
    b = (1.f - c) / th2;
    da = (th * c - s) / (2.f * th2 * th);
    db = (th * s - 2.f * (1.f - c)) / (2.f * th2 * th2);
  }
  const float K[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float k2 = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      R[i][j] = (i == j ? 1.f : 0.f) + a * K[i][j] + b * k2;
    }
  float xc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) xc[i] = R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2] + t[i];
  const bool zsmall = fabsf(xc[2]) < 1e-12f;
  const float z = zsmall ? 1e-12f : xc[2];
  const float fx = intr[0], fy = intr[1];
  o->r[0] = fx * xc[0] / z + intr[2] - x;
  o->r[1] = fy * xc[1] / z + intr[3] - y;
  if (!with_jac) return;

  // d r / d x_cam (2 x 3); the clamped depth has no derivative.
  const float D[2][3] = {{fx / z, 0.f, zsmall ? 0.f : -fx * xc[0] / (z * z)},
                         {0.f, fy / z, zsmall ? 0.f : -fy * xc[1] / (z * z)}};
  // d(R X)/d w = (K X)(2 da w^T) - a [X]x + (K^2 X)(2 db w^T)
  //              + b ((w.X) I + w X^T - 2 X w^T).
  float KX[3], K2X[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) KX[i] = K[i][0] * X[0] + K[i][1] * X[1] + K[i][2] * X[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) K2X[i] = K[i][0] * KX[0] + K[i][1] * KX[1] + K[i][2] * KX[2];
  const float wx = w[0] * X[0] + w[1] * X[1] + w[2] * X[2];
  const float SX[3][3] = {{0.f, -X[2], X[1]}, {X[2], 0.f, -X[0]}, {-X[1], X[0], 0.f}};
  float dRX[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dRX[i][j] = 2.f * da * KX[i] * w[j] - a * SX[i][j] + 2.f * db * K2X[i] * w[j] +
                  b * ((i == j ? wx : 0.f) + w[i] * X[j] - 2.f * X[i] * w[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o->Jc[r][j] = D[r][0] * dRX[0][j] + D[r][1] * dRX[1][j] + D[r][2] * dRX[2][j];
      o->Jc[r][3 + j] = D[r][j];
      o->Jp[r][j] = D[r][0] * R[0][j] + D[r][1] * R[1][j] + D[r][2] * R[2][j];
    }
  }
  o->Jk[0][0] = xc[0] / z; o->Jk[0][1] = 0.f; o->Jk[0][2] = 1.f; o->Jk[0][3] = 0.f;
  o->Jk[1][0] = 0.f; o->Jk[1][1] = xc[1] / z; o->Jk[1][2] = 0.f; o->Jk[1][3] = 1.f;
}

__global__ void __launch_bounds__(NT) ba_obs_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const float* __restrict__ obs_xy, const float* __restrict__ obs_w,
    const float* __restrict__ cam_free, const float* __restrict__ point_valid,
    int C, int O, float delta, int opt_k, float* __restrict__ Jc_out,
    float* __restrict__ Jk_out, float* __restrict__ Jp_out, float* __restrict__ rw_out,
    float* __restrict__ U, float* __restrict__ g_c, float* __restrict__ Uk,
    float* __restrict__ g_k) {
  extern __shared__ float sm[];  // C x (36 U + 6 g_c), then 16 Uk + 4 g_k
  float* sU = sm;
  float* sg = sm + 36 * C;
  float* sk = sm + 42 * C;
  for (int i = threadIdx.x; i < 42 * C + 20; i += NT) sm[i] = 0.f;
  __syncthreads();
  float in_k[4];
  for (int k = 0; k < 4; ++k) in_k[k] = intr[k];

  for (int base = blockIdx.x * NT; base < O; base += gridDim.x * NT) {
    const int o = base + threadIdx.x;
    const float wv = o < O ? obs_w[o] : 0.f;
    Obs ob;
    float rw[2] = {0.f, 0.f};
    int c = 0;
    if (wv != 0.f) {
      c = obs_cam[o];
      const int p = obs_point[o];
      residual_jac<true>(rvec + 3 * c, tvec + 3 * c, in_k, points + 3 * p, obs_xy[2 * o],
                         obs_xy[2 * o + 1], &ob);
      const float nrm = sqrtf(ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1]);
      const float hw = nrm <= delta ? 1.f : delta / fmaxf(nrm, 1e-12f);
      const float sw = sqrtf(hw * wv);
      const float sc = sw * cam_free[c], sp = sw * point_valid[p], sk_ = opt_k ? sw : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rw[r] = ob.r[r] * sw;
#pragma unroll
        for (int j = 0; j < 6; ++j) ob.Jc[r][j] *= sc;
#pragma unroll
        for (int j = 0; j < 4; ++j) ob.Jk[r][j] *= sk_;
#pragma unroll
        for (int j = 0; j < 3; ++j) ob.Jp[r][j] *= sp;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 6; ++j) ob.Jc[r][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) ob.Jk[r][j] = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) ob.Jp[r][j] = 0.f;
      }
    }
    if (o < O) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 6; ++j) Jc_out[(size_t)o * 12 + r * 6 + j] = ob.Jc[r][j];
#pragma unroll
        for (int j = 0; j < 4; ++j) Jk_out[(size_t)o * 8 + r * 4 + j] = ob.Jk[r][j];
#pragma unroll
        for (int j = 0; j < 3; ++j) Jp_out[(size_t)o * 6 + r * 3 + j] = ob.Jp[r][j];
        rw_out[(size_t)o * 2 + r] = rw[r];
      }
    }
    if (wv != 0.f && cam_free[c] != 0.f) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
          const float v = ob.Jc[0][i] * ob.Jc[0][j] + ob.Jc[1][i] * ob.Jc[1][j];
          atomicAdd(&sU[c * 36 + i * 6 + j], v);
        }
        atomicAdd(&sg[c * 6 + i], ob.Jc[0][i] * rw[0] + ob.Jc[1][i] * rw[1]);
      }
    }
    if (opt_k) {
      float kk[20];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[i * 4 + j] = ob.Jk[0][i] * ob.Jk[0][j] + ob.Jk[1][i] * ob.Jk[1][j];
        kk[16 + i] = ob.Jk[0][i] * rw[0] + ob.Jk[1][i] * rw[1];
      }
#pragma unroll
      for (int k = 0; k < 20; ++k) {
        float v = kk[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (threadIdx.x % 32 == 0 && v != 0.f) atomicAdd(&sk[k], v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 36 * C; i += NT) {
    const int cam = i / 36, e = i % 36, r = e / 6, col = e % 6;
    const float v = sU[cam * 36 + min(r, col) * 6 + max(r, col)];  // upper triangle
    if (v != 0.f) atomicAdd(&U[i], v);
  }
  for (int i = threadIdx.x; i < 6 * C; i += NT)
    if (sg[i] != 0.f) atomicAdd(&g_c[i], sg[i]);
  if (threadIdx.x < 16 && sk[threadIdx.x] != 0.f) atomicAdd(&Uk[threadIdx.x], sk[threadIdx.x]);
  if (threadIdx.x < 4 && sk[16 + threadIdx.x] != 0.f)
    atomicAdd(&g_k[threadIdx.x], sk[16 + threadIdx.x]);
}

__global__ void __launch_bounds__(NT) ba_point_kernel(
    const int* __restrict__ obs_point, const int* __restrict__ perm,
    const uint8_t* __restrict__ perm_valid, int G, int Vs,
    const float* __restrict__ Jp, const float* __restrict__ rw, float* __restrict__ V,
    float* __restrict__ g_p) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= G || !perm_valid[(size_t)g * Vs]) return;
  float v[9] = {0.f}, gp[3] = {0.f, 0.f, 0.f};
  for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
    const int o = perm[(size_t)g * Vs + s];
    const float* J = Jp + (size_t)o * 6;
    const float r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[i * 3 + j] += J[i] * J[j] + J[3 + i] * J[3 + j];
      gp[i] += J[i] * r0 + J[3 + i] * r1;
    }
  }
  const int p = obs_point[perm[(size_t)g * Vs]];
  for (int k = 0; k < 9; ++k) V[(size_t)p * 9 + k] = v[k];
  for (int k = 0; k < 3; ++k) g_p[(size_t)p * 3 + k] = gp[k];
}

__global__ void __launch_bounds__(NT) ba_cost_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const float* __restrict__ obs_xy, const float* __restrict__ obs_w, int O,
    float delta, double* __restrict__ out) {
  __shared__ double warp_sum[NT / 32];
  float in_k[4];
  for (int k = 0; k < 4; ++k) in_k[k] = intr[k];
  double acc = 0.0;
  for (int o = blockIdx.x * NT + threadIdx.x; o < O; o += gridDim.x * NT) {
    if (!(obs_w[o] > 0.f)) continue;
    const int c = obs_cam[o], p = obs_point[o];
    Obs ob;
    residual_jac<false>(rvec + 3 * c, tvec + 3 * c, in_k, points + 3 * p, obs_xy[2 * o],
                        obs_xy[2 * o + 1], &ob);
    const float nrm = sqrtf(ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1]);
    acc += nrm <= delta ? 0.5f * nrm * nrm : delta * (nrm - 0.5f * delta);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int i = 0; i < NT / 32; ++i) s += warp_sum[i];
    atomicAdd(out, s);
  }
}

int grid_for(int O) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(1, min((O + NT - 1) / NT, 4 * sms));
}

}  // namespace

SFM_API int sfm_ba_linearize(const void* rvec, const void* tvec, const void* intr,
                             const void* points, const void* obs_cam,
                             const void* obs_point, const void* obs_xy,
                             const void* obs_w, const void* cam_free,
                             const void* point_valid, const void* perm,
                             const void* perm_valid, int C, int P, int O, int G, int Vs,
                             float delta, int opt_k, void* Jc, void* Jk, void* Jp,
                             void* rw, void* U, void* g_c, void* Uk, void* g_k, void* V,
                             void* g_p, void* stream) {
  (void)P;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(42 * C + 20) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ba_obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (O > 0) {
    ba_obs_kernel<<<grid_for(O), NT, smem, st>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w),
        static_cast<const float*>(cam_free), static_cast<const float*>(point_valid), C, O,
        delta, opt_k, static_cast<float*>(Jc), static_cast<float*>(Jk),
        static_cast<float*>(Jp), static_cast<float*>(rw), static_cast<float*>(U),
        static_cast<float*>(g_c), static_cast<float*>(Uk), static_cast<float*>(g_k));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (G > 0) {
    ba_point_kernel<<<(G + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const int*>(obs_point), static_cast<const int*>(perm),
        static_cast<const uint8_t*>(perm_valid), G, Vs, static_cast<const float*>(Jp),
        static_cast<const float*>(rw), static_cast<float*>(V), static_cast<float*>(g_p));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_ba_cost(const void* rvec, const void* tvec, const void* intr,
                        const void* points, const void* obs_cam, const void* obs_point,
                        const void* obs_xy, const void* obs_w, int O, float delta,
                        void* out, void* stream) {
  if (O > 0) {
    ba_cost_kernel<<<grid_for(O), NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w), O, delta,
        static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
