// Kernel K8+K9: BA residuals, analytic Jacobians, Huber whitening and the
// lambda-independent reductions of the LM normal equations; plus the Huber cost.
//
// Replaces sfm_tpu/ba/residuals.py::residuals_and_jacobians (:68, vmapped
// jax.jacrev of residual_one in 131k-row chunks) and ba/schur.py::
// linearize_system (:119, whitening + segment sums into V, g_p, U, g_c, Uk,
// g_k), which XLA ran as separate passes over (O, 2, 13) Jacobian tensors.
//
// sfm_ba_linearize launches five kernels:
//  1. one thread per observation row (grid-stride): Rodrigues with the
//     theta^2 < 1e-8 Taylor branch of rotations.py::rodrigues, the projection
//     with shared intrinsics, the residual, the analytic Jacobians (the
//     derivative of that same branch, so rvec = 0 -- the seed camera -- gives
//     finite values), the Huber weight and the whitening
//     sqrt(w * obs_w) * cam_free (camera) / * point_valid (point). It writes
//     the whitened Jc, Jk, Jp, rw (read by K10 and the back-substitution) and
//     takes the largest |entry| of every camera's Jc columns and residuals
//     and of Jk's columns (atomic max, warp-reduced for the intrinsics);
//  2. the shifts of the order-free sums (sfm_common.cuh) of U's upper
//     triangle, g_c, Uk's upper triangle and g_k, from those maxima and the
//     row count (a term is at most max_i * max_j, two rows an observation);
//  3. one thread per observation row again: the camera side (U, g_c) and the
//     intrinsics (Uk, g_k) as 64-bit fixed-point atomics (the intrinsics
//     warp-reduced first), the same bits in any order;
//  4. the sums rounded to float, U and Uk mirrored;
//  5. one thread per row of the per-point grouping (schur.py::coobs_pairs):
//     V and g_p as a plain loop over the point's observations, no atomics.
// Dead rows (obs_w == 0) write zeros and skip all arithmetic. So every
// launch gives the same bits (float atomics did not: the LM path, and the
// incremental engine's registrations after it, changed from run to run).
// sfm_ba_cost: the Huber cost of every row with obs_w > 0 (the LM accept
// test), each block's f64 sum written to its slot, then the slots added in
// order by one warp: deterministic, with a grid that does not depend on the
// card's SM count.
//
// What bounds it on the H100: ~400 FLOP per observation (200k rows: 80 MFLOP)
// and ~140 bytes written per row (28 MB); both are microseconds, so launches
// and the camera atomics dominate at the main path's sizes.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int COST_BLOCKS = 512;  // the cost's partial sums (a fixed grid)
constexpr int NU = 21;            // U's upper triangle
constexpr int NCAM = NU + 6;      // + g_c: the fixed-point sums of a camera
constexpr int NK = 10 + 4;        // Uk's upper triangle + g_k
constexpr int CMAX = 7;           // a camera's maxima: Jc's 6 columns, rw

// (i, j), i <= j, of the k-th entry of an n x n upper triangle (row-major).
__device__ __forceinline__ void upper_ij(int k, int n, int& i, int& j) {
  i = 0;
  while (k >= n - i) {
    k -= n - i;
    ++i;
  }
  j = i + k;
}

// Max of v over the warp's lanes, then one atomic max per warp.
__device__ __forceinline__ void warp_fx_max(unsigned int* m, float v) {
  const unsigned int b = __reduce_max_sync(0xffffffffu, __float_as_uint(fabsf(v)));
  if (threadIdx.x % 32 == 0 && b != 0u) atomicMax(m, b);
}

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
    unsigned int* __restrict__ cmax, unsigned int* __restrict__ kmax) {
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
    const float rmax = fmaxf(fabsf(rw[0]), fabsf(rw[1]));
    if (wv != 0.f && cam_free[c] != 0.f) {
#pragma unroll
      for (int i = 0; i < 6; ++i)
        sfm_fx_max(&cmax[c * CMAX + i], fmaxf(fabsf(ob.Jc[0][i]), fabsf(ob.Jc[1][i])));
      sfm_fx_max(&cmax[c * CMAX + 6], rmax);
    }
    if (opt_k) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        warp_fx_max(&kmax[i], fmaxf(fabsf(ob.Jk[0][i]), fabsf(ob.Jk[1][i])));
      warp_fx_max(&kmax[4], rmax);
    }
  }
}

// Shifts of the fixed-point sums: C x (21 U + 6 g_c), then 10 Uk + 4 g_k.
__global__ void __launch_bounds__(NT) ba_shift_kernel(const unsigned int* __restrict__ cmax,
                                                      const unsigned int* __restrict__ kmax,
                                                      int C, double rows,
                                                      int* __restrict__ sh) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < NCAM * C) {
    const int c = e / NCAM, k = e % NCAM;
    const unsigned int* m = cmax + c * CMAX;
    int i = 6, j = k - NU;  // g_c: column j times the residual
    if (k < NU) upper_ij(k, 6, i, j);
    const double b = (double)__uint_as_float(m[i]) * (double)__uint_as_float(m[j]);
    sh[e] = sfm_fx_shift(b * rows);
  } else if (e < NCAM * C + NK) {
    const int k = e - NCAM * C;
    int i = 4, j = k - 10;
    if (k < 10) upper_ij(k, 4, i, j);
    const double b = (double)__uint_as_float(kmax[i]) * (double)__uint_as_float(kmax[j]);
    sh[e] = sfm_fx_shift(b * rows);
  }
}

// The camera and intrinsics sums, order-free, from the whitened Jc, Jk, rw.
__global__ void __launch_bounds__(NT) ba_sum_kernel(
    const int* __restrict__ obs_cam, const float* __restrict__ obs_w,
    const float* __restrict__ cam_free, const float* __restrict__ Jc,
    const float* __restrict__ Jk, const float* __restrict__ rw, int C, int O, int opt_k,
    const int* __restrict__ sh, unsigned long long* __restrict__ acc) {
  const int* ksh = sh + NCAM * C;
  unsigned long long* kacc = acc + NCAM * C;
  for (int base = blockIdx.x * NT; base < O; base += gridDim.x * NT) {
    const int o = base + threadIdx.x;
    const float wv = o < O ? obs_w[o] : 0.f;
    if (wv != 0.f) {
      const int c = obs_cam[o];
      if (cam_free[c] != 0.f) {
        const float* jc = Jc + (size_t)o * 12;
        const float r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
        const int* s = sh + c * NCAM;
        unsigned long long* a = acc + (size_t)c * NCAM;
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j, ++k)
            sfm_fx_add(&a[k], jc[i] * jc[j] + jc[6 + i] * jc[6 + j], s[k]);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          sfm_fx_add(&a[NU + i], jc[i] * r0 + jc[6 + i] * r1, s[NU + i]);
      }
    }
    if (opt_k) {  // warp sums of the integers (any order: the same bits)
      long long v[NK];
      if (wv != 0.f) {
        const float* jk = Jk + (size_t)o * 8;
        const float r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
        int k = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = i; j < 4; ++j, ++k)
            v[k] = ksh[k] == SFM_FX_BAD ? 0 : sfm_fx_of(jk[i] * jk[j] + jk[4 + i] * jk[4 + j], ksh[k]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[10 + i] = ksh[10 + i] == SFM_FX_BAD ? 0 : sfm_fx_of(jk[i] * r0 + jk[4 + i] * r1, ksh[10 + i]);
      } else {
#pragma unroll
        for (int k = 0; k < NK; ++k) v[k] = 0;
      }
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        long long t = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
        if (threadIdx.x % 32 == 0 && t != 0)
          atomicAdd(&kacc[k], static_cast<unsigned long long>(t));
      }
    }
  }
}

// The sums rounded to float; U and Uk mirrored from their upper triangles.
__global__ void __launch_bounds__(NT) ba_finish_kernel(const unsigned long long* __restrict__ acc,
                                                       const int* __restrict__ sh, int C,
                                                       float* __restrict__ U,
                                                       float* __restrict__ g_c,
                                                       float* __restrict__ Uk,
                                                       float* __restrict__ g_k) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < 36 * C) {
    const int c = e / 36, r = e % 36 / 6, col = e % 6;
    const int i = min(r, col), j = max(r, col);
    const int k = c * NCAM + i * 6 - i * (i - 1) / 2 + (j - i);
    U[e] = (float)sfm_fx_value(acc[k], sh[k]);
  } else if (e < 42 * C) {
    const int c = (e - 36 * C) / 6, i = (e - 36 * C) % 6;
    const int k = c * NCAM + NU + i;
    g_c[c * 6 + i] = (float)sfm_fx_value(acc[k], sh[k]);
  } else if (e < 42 * C + 16) {
    const int r = (e - 42 * C) / 4, col = (e - 42 * C) % 4;
    const int i = min(r, col), j = max(r, col);
    const int k = NCAM * C + i * 4 - i * (i - 1) / 2 + (j - i);
    Uk[r * 4 + col] = (float)sfm_fx_value(acc[k], sh[k]);
  } else if (e < 42 * C + 20) {
    const int i = e - 42 * C - 16;
    const int k = NCAM * C + 10 + i;
    g_k[i] = (float)sfm_fx_value(acc[k], sh[k]);
  }
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
    float delta, double* __restrict__ partial) {
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
    partial[blockIdx.x] = s;
  }
}

// The blocks' partial costs added in a fixed order by one warp.
__global__ void ba_cost_sum_kernel(const double* __restrict__ partial, int n,
                                   double* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += 32) s += partial[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) *out = s;
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
                             void* g_p, void* fx_max, void* fx_sh, void* fx_acc,
                             void* stream) {
  // fx_max: C x 7 + 5 uint32; fx_sh: C x 27 + 14 int32; fx_acc: C x 27 + 14 uint64.
  (void)P;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nfx = NCAM * C + NK;
  unsigned int* cmax = static_cast<unsigned int*>(fx_max);
  cudaError_t e = cudaMemsetAsync(cmax, 0, (size_t)(CMAX * C + 5) * sizeof(unsigned int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(fx_acc, 0, (size_t)nfx * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (O > 0) {
    ba_obs_kernel<<<grid_for(O), NT, 0, st>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w),
        static_cast<const float*>(cam_free), static_cast<const float*>(point_valid), C, O,
        delta, opt_k, static_cast<float*>(Jc), static_cast<float*>(Jk),
        static_cast<float*>(Jp), static_cast<float*>(rw), cmax, cmax + CMAX * C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ba_shift_kernel<<<(nfx + NT - 1) / NT, NT, 0, st>>>(cmax, cmax + CMAX * C, C,
                                                      2.0 * (double)O,
                                                      static_cast<int*>(fx_sh));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (O > 0) {
    ba_sum_kernel<<<grid_for(O), NT, 0, st>>>(
        static_cast<const int*>(obs_cam), static_cast<const float*>(obs_w),
        static_cast<const float*>(cam_free), static_cast<const float*>(Jc),
        static_cast<const float*>(Jk), static_cast<const float*>(rw), C, O, opt_k,
        static_cast<const int*>(fx_sh), static_cast<unsigned long long*>(fx_acc));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ba_finish_kernel<<<(42 * C + 20 + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const unsigned long long*>(fx_acc), static_cast<const int*>(fx_sh), C,
      static_cast<float*>(U), static_cast<float*>(g_c), static_cast<float*>(Uk),
      static_cast<float*>(g_k));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
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
                        void* out, void* partial, void* stream) {
  // partial: COST_BLOCKS doubles of scratch.
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O > 0) {
    const int grid = min((O + NT - 1) / NT, COST_BLOCKS);
    ba_cost_kernel<<<grid, NT, 0, st>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w), O, delta,
        static_cast<double*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ba_cost_sum_kernel<<<1, 32, 0, st>>>(static_cast<const double*>(partial), grid,
                                         static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
