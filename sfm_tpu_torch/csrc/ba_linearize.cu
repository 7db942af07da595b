// Kernel K8+K9: BA residuals, analytic Jacobians, Huber whitening and the
// lambda-independent reductions of the LM normal equations; plus the Huber cost.
//
// Replaces sfm_tpu/ba/residuals.py::residuals_and_jacobians (:68, vmapped
// jax.jacrev of residual_one in 131k-row chunks), its per-camera variant
// residuals_and_jacobians_percam (:90), and ba/schur.py::linearize_system
// (:119, whitening + segment sums into V, g_p, U, g_c, Uk, g_k), which XLA
// ran as separate passes over (O, 2, 13) Jacobian tensors.
//
// Templated on the camera block B and on the island's scalar T (ba/lm.py
// :130-212): B = 6 (pose; shared intrinsics in Jk) or 10 (pose | fx fy cx
// cy, BAConfig.per_camera_intrinsics: the intrinsics columns are the shared
// path's Jk at the camera's own K, whitened by sqrt(w) alone, so a pinned
// camera's intrinsics stay free; Jk is then the dead zero system), and
// T = float or double (BAConfig.f64_normal_equations: the Jacobians are
// f32, the whitening, the outputs and the sums are double, the sums two
// words a target, sfm_common.cuh). B = 6, float is the default route, and
// its arithmetic is the one the other instantiations generalize.
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
//     warp-reduced first), the same bits in any order. At B = 6 a camera
//     whose cam_free is 0 has zero columns and is skipped; at B = 10 its
//     four intrinsics columns are summed (its pose columns are zero);
//  4. the sums rounded to T, U and Uk mirrored; the per-camera additions
//     U_extra and g_c_extra (the per-camera intrinsics regularization, zero
//     for an invalid camera) added once, after the rounding;
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
// and the camera atomics dominate at the main path's sizes. B = 10 has 65
// camera sums an observation where B = 6 has 27, and T = double two atomics
// a term.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int COST_BLOCKS = 512;  // the cost's partial sums (a fixed grid)
constexpr int NK = 10 + 4;        // Uk's upper triangle + g_k

// A camera's fixed-point sums: U's upper triangle (NU), then g_c (B); and its
// maxima: Jc's B columns, then rw.
template <int B>
struct Cam {
  static constexpr int NU = B * (B + 1) / 2;
  static constexpr int NCAM = NU + B;
  static constexpr int CMAX = B + 1;
};

// (i, j), i <= j, of the k-th entry of an n x n upper triangle (row-major).
__device__ __forceinline__ void upper_ij(int k, int n, int& i, int& j) {
  i = 0;
  while (k >= n - i) {
    k -= n - i;
    ++i;
  }
  j = i + k;
}

// Max of |v| over the warp's lanes, then one atomic max per warp.
template <typename T>
__device__ __forceinline__ void warp_fx_max(unsigned int* m, T v) {
  const unsigned int b = __reduce_max_sync(0xffffffffu, sfm_fx_mag(v));
  if (threadIdx.x % 32 == 0 && b != 0u) atomicMax(m, b);
}

__device__ __forceinline__ float t_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double t_abs(double x) { return fabs(x); }
__device__ __forceinline__ float t_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_max(double a, double b) { return fmax(a, b); }
// sqrt(w * obs_w) in the island's type (ba/lm.py:204-212 casts both to f64).
__device__ __forceinline__ void whiten_scale(float hw, float wv, float* sw) { *sw = sqrtf(hw * wv); }
__device__ __forceinline__ void whiten_scale(float hw, float wv, double* sw) {
  *sw = sqrt((double)hw * (double)wv);
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

template <int B, typename T>
__global__ void __launch_bounds__(NT) ba_obs_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const float* __restrict__ obs_xy, const float* __restrict__ obs_w,
    const float* __restrict__ cam_free, const float* __restrict__ point_valid,
    int C, int O, float delta, int opt_k, T* __restrict__ Jc_out,
    T* __restrict__ Jk_out, T* __restrict__ Jp_out, T* __restrict__ rw_out,
    unsigned int* __restrict__ cmax, unsigned int* __restrict__ kmax) {
  constexpr int CMAX = Cam<B>::CMAX;
  float in_k[4];  // the shared K (B = 6); B = 10 reads each camera's own
  if (B == 6)
    for (int k = 0; k < 4; ++k) in_k[k] = intr[k];

  for (int base = blockIdx.x * NT; base < O; base += gridDim.x * NT) {
    const int o = base + threadIdx.x;
    const float wv = o < O ? obs_w[o] : 0.f;
    T jc[2][B], jk[2][4], jp[2][3];
    T rw[2] = {T(0), T(0)};
    int c = 0;
    if (wv != 0.f) {
      c = obs_cam[o];
      const int p = obs_point[o];
      Obs ob;
      residual_jac<true>(rvec + 3 * c, tvec + 3 * c, B == 6 ? in_k : intr + 4 * c,
                         points + 3 * p, obs_xy[2 * o], obs_xy[2 * o + 1], &ob);
      const float nrm = sqrtf(ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1]);
      const float hw = nrm <= delta ? 1.f : delta / fmaxf(nrm, 1e-12f);
      T sw;
      whiten_scale(hw, wv, &sw);
      const T sc = sw * (T)cam_free[c], sp = sw * (T)point_valid[p], sk_ = opt_k ? sw : T(0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rw[r] = (T)ob.r[r] * sw;
#pragma unroll
        for (int j = 0; j < 6; ++j) jc[r][j] = (T)ob.Jc[r][j] * sc;
#pragma unroll
        for (int j = 6; j < B; ++j) jc[r][j] = (T)ob.Jk[r][j - 6] * sw;
#pragma unroll
        for (int j = 0; j < 4; ++j) jk[r][j] = (T)ob.Jk[r][j] * sk_;
#pragma unroll
        for (int j = 0; j < 3; ++j) jp[r][j] = (T)ob.Jp[r][j] * sp;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < B; ++j) jc[r][j] = T(0);
#pragma unroll
        for (int j = 0; j < 4; ++j) jk[r][j] = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) jp[r][j] = T(0);
      }
    }
    if (o < O) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < B; ++j) Jc_out[(size_t)o * 2 * B + r * B + j] = jc[r][j];
#pragma unroll
        for (int j = 0; j < 4; ++j) Jk_out[(size_t)o * 8 + r * 4 + j] = jk[r][j];
#pragma unroll
        for (int j = 0; j < 3; ++j) Jp_out[(size_t)o * 6 + r * 3 + j] = jp[r][j];
        rw_out[(size_t)o * 2 + r] = rw[r];
      }
    }
    const T rmax = t_max(t_abs(rw[0]), t_abs(rw[1]));
    if (wv != 0.f && (B == 10 || cam_free[c] != 0.f)) {
#pragma unroll
      for (int i = 0; i < B; ++i)
        atomicMax(&cmax[c * CMAX + i], sfm_fx_mag(t_max(t_abs(jc[0][i]), t_abs(jc[1][i]))));
      atomicMax(&cmax[c * CMAX + B], sfm_fx_mag(rmax));
    }
    if (opt_k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) warp_fx_max(&kmax[i], t_max(t_abs(jk[0][i]), t_abs(jk[1][i])));
      warp_fx_max(&kmax[4], rmax);
    }
  }
}

// Shifts of the fixed-point sums: C x (NU U + B g_c), then 10 Uk + 4 g_k.
template <int B, typename T>
__global__ void __launch_bounds__(NT) ba_shift_kernel(const unsigned int* __restrict__ cmax,
                                                      const unsigned int* __restrict__ kmax,
                                                      int C, double rows,
                                                      int* __restrict__ sh) {
  constexpr int NU = Cam<B>::NU, NCAM = Cam<B>::NCAM;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < NCAM * C) {
    const int c = e / NCAM, k = e % NCAM;
    const unsigned int* m = cmax + c * Cam<B>::CMAX;
    int i = B, j = k - NU;  // g_c: column j times the residual
    if (k < NU) upper_ij(k, B, i, j);
    const double b = (double)__uint_as_float(m[i]) * (double)__uint_as_float(m[j]);
    sh[e] = sfm_fx_shift_t<T>(b * rows);
  } else if (e < NCAM * C + NK) {
    const int k = e - NCAM * C;
    int i = 4, j = k - 10;
    if (k < 10) upper_ij(k, 4, i, j);
    const double b = (double)__uint_as_float(kmax[i]) * (double)__uint_as_float(kmax[j]);
    sh[e] = sfm_fx_shift_t<T>(b * rows);
  }
}

// The camera and intrinsics sums, order-free, from the whitened Jc, Jk, rw
// (nfx targets: a target's second word, for T = double, nfx further on).
template <int B, typename T>
__global__ void __launch_bounds__(NT) ba_sum_kernel(
    const int* __restrict__ obs_cam, const float* __restrict__ obs_w,
    const float* __restrict__ cam_free, const T* __restrict__ Jc,
    const T* __restrict__ Jk, const T* __restrict__ rw, int C, int O, int opt_k,
    const int* __restrict__ sh, unsigned long long* __restrict__ acc) {
  constexpr int NU = Cam<B>::NU, NCAM = Cam<B>::NCAM, W = SfmFx<T>::WORDS;
  const size_t nfx = (size_t)NCAM * C + NK;
  const int* ksh = sh + NCAM * C;
  for (int base = blockIdx.x * NT; base < O; base += gridDim.x * NT) {
    const int o = base + threadIdx.x;
    const float wv = o < O ? obs_w[o] : 0.f;
    if (wv != 0.f) {
      const int c = obs_cam[o];
      if (B == 10 || cam_free[c] != 0.f) {
        const T* jc = Jc + (size_t)o * 2 * B;
        const T r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
        const int* s = sh + c * NCAM;
        const size_t a = (size_t)c * NCAM;
        int k = 0;
#pragma unroll
        for (int i = 0; i < B; ++i)
#pragma unroll
          for (int j = i; j < B; ++j, ++k)
            sfm_fx_add_t<T>(acc, nfx, a + k, jc[i] * jc[j] + jc[B + i] * jc[B + j], s[k]);
#pragma unroll
        for (int i = 0; i < B; ++i)
          sfm_fx_add_t<T>(acc, nfx, a + NU + i, jc[i] * r0 + jc[B + i] * r1, s[NU + i]);
      }
    }
    if (opt_k) {  // warp sums of the integers (any order: the same bits)
      long long v[NK][W];
      if (wv != 0.f) {
        const T* jk = Jk + (size_t)o * 8;
        const T r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
        T x[NK];
        int k = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = i; j < 4; ++j, ++k) x[k] = jk[i] * jk[j] + jk[4 + i] * jk[4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[10 + i] = jk[i] * r0 + jk[4 + i] * r1;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const SfmFxQ q = ksh[k] == SFM_FX_BAD ? SfmFxQ{0, 0} : sfm_fx_q(x[k], ksh[k]);
          v[k][0] = q.hi;
          if (W == 2) v[k][W - 1] = q.lo;
        }
      } else {
#pragma unroll
        for (int k = 0; k < NK; ++k)
#pragma unroll
          for (int w = 0; w < W; ++w) v[k][w] = 0;
      }
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          long long t = v[k][w];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
          if (threadIdx.x % 32 == 0 && t != 0)
            atomicAdd(&acc[w * nfx + NCAM * C + k], static_cast<unsigned long long>(t));
        }
    }
  }
}

// The sums rounded to T; U and Uk mirrored from their upper triangles; then
// U_extra (C, B, B) and g_c_extra (C, B) added where given.
template <int B, typename T>
__global__ void __launch_bounds__(NT) ba_finish_kernel(
    const unsigned long long* __restrict__ acc, const int* __restrict__ sh, int C,
    const T* __restrict__ U_extra, const T* __restrict__ g_c_extra, T* __restrict__ U,
    T* __restrict__ g_c, T* __restrict__ Uk, T* __restrict__ g_k) {
  constexpr int NU = Cam<B>::NU, NCAM = Cam<B>::NCAM, BB = B * B;
  const size_t nfx = (size_t)NCAM * C + NK;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e < BB * C) {
    const int c = e / BB, r = e % BB / B, col = e % B;
    const int i = min(r, col), j = max(r, col);
    const int k = c * NCAM + i * B - i * (i - 1) / 2 + (j - i);
    const T v = (T)sfm_fx_value_t<T>(acc, nfx, k, sh[k]);
    U[e] = U_extra != nullptr ? v + U_extra[e] : v;
  } else if (e < (BB + B) * C) {
    const int c = (e - BB * C) / B, i = (e - BB * C) % B;
    const int k = c * NCAM + NU + i;
    const T v = (T)sfm_fx_value_t<T>(acc, nfx, k, sh[k]);
    g_c[c * B + i] = g_c_extra != nullptr ? v + g_c_extra[c * B + i] : v;
  } else if (e < (BB + B) * C + 16) {
    const int r = (e - (BB + B) * C) / 4, col = (e - (BB + B) * C) % 4;
    const int i = min(r, col), j = max(r, col);
    const int k = NCAM * C + i * 4 - i * (i - 1) / 2 + (j - i);
    Uk[r * 4 + col] = (T)sfm_fx_value_t<T>(acc, nfx, k, sh[k]);
  } else if (e < (BB + B) * C + 20) {
    const int i = e - (BB + B) * C - 16;
    const int k = NCAM * C + 10 + i;
    g_k[i] = (T)sfm_fx_value_t<T>(acc, nfx, k, sh[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ba_point_kernel(
    const int* __restrict__ obs_point, const int* __restrict__ perm,
    const uint8_t* __restrict__ perm_valid, int G, int Vs,
    const T* __restrict__ Jp, const T* __restrict__ rw, T* __restrict__ V,
    T* __restrict__ g_p) {
  const int g = blockIdx.x * NT + threadIdx.x;
  if (g >= G || !perm_valid[(size_t)g * Vs]) return;
  T v[9] = {T(0)}, gp[3] = {T(0), T(0), T(0)};
  for (int s = 0; s < Vs && perm_valid[(size_t)g * Vs + s]; ++s) {
    const int o = perm[(size_t)g * Vs + s];
    const T* J = Jp + (size_t)o * 6;
    const T r0 = rw[(size_t)o * 2], r1 = rw[(size_t)o * 2 + 1];
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

// PERCAM: intr holds each camera's (fx, fy, cx, cy), else the shared four.
template <bool PERCAM>
__global__ void __launch_bounds__(NT) ba_cost_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const int* __restrict__ obs_cam, const int* __restrict__ obs_point,
    const float* __restrict__ obs_xy, const float* __restrict__ obs_w, int O,
    float delta, double* __restrict__ partial) {
  __shared__ double warp_sum[NT / 32];
  float in_k[4];
  if (!PERCAM)
    for (int k = 0; k < 4; ++k) in_k[k] = intr[k];
  double acc = 0.0;
  for (int o = blockIdx.x * NT + threadIdx.x; o < O; o += gridDim.x * NT) {
    if (!(obs_w[o] > 0.f)) continue;
    const int c = obs_cam[o], p = obs_point[o];
    Obs ob;
    residual_jac<false>(rvec + 3 * c, tvec + 3 * c, PERCAM ? intr + 4 * c : in_k,
                        points + 3 * p, obs_xy[2 * o], obs_xy[2 * o + 1], &ob);
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

// fx_max: C x (B + 1) + 5 uint32; fx_sh: nfx int32; fx_acc: WORDS x nfx uint64,
// nfx = C x (B (B + 1) / 2 + B) + 14.
template <int B, typename T>
int ba_linearize(const void* rvec, const void* tvec, const void* intr, const void* points,
                 const void* obs_cam, const void* obs_point, const void* obs_xy,
                 const void* obs_w, const void* cam_free, const void* point_valid,
                 const void* perm, const void* perm_valid, int C, int O, int G, int Vs,
                 float delta, int opt_k, void* Jc, void* Jk, void* Jp, void* rw, void* U,
                 void* g_c, void* Uk, void* g_k, void* V, void* g_p, void* fx_max,
                 void* fx_sh, void* fx_acc, const void* U_extra, const void* g_c_extra,
                 cudaStream_t st) {
  constexpr int NCAM = Cam<B>::NCAM, CMAX = Cam<B>::CMAX;
  const int nfx = NCAM * C + NK;
  unsigned int* cmax = static_cast<unsigned int*>(fx_max);
  cudaError_t e = cudaMemsetAsync(cmax, 0, (size_t)(CMAX * C + 5) * sizeof(unsigned int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(fx_acc, 0, (size_t)SfmFx<T>::WORDS * nfx * sizeof(unsigned long long),
                        st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (O > 0) {
    ba_obs_kernel<B, T><<<grid_for(O), NT, 0, st>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
        static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w),
        static_cast<const float*>(cam_free), static_cast<const float*>(point_valid), C, O,
        delta, opt_k, static_cast<T*>(Jc), static_cast<T*>(Jk), static_cast<T*>(Jp),
        static_cast<T*>(rw), cmax, cmax + CMAX * C);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ba_shift_kernel<B, T><<<(nfx + NT - 1) / NT, NT, 0, st>>>(cmax, cmax + CMAX * C, C,
                                                            2.0 * (double)O,
                                                            static_cast<int*>(fx_sh));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (O > 0) {
    ba_sum_kernel<B, T><<<grid_for(O), NT, 0, st>>>(
        static_cast<const int*>(obs_cam), static_cast<const float*>(obs_w),
        static_cast<const float*>(cam_free), static_cast<const T*>(Jc),
        static_cast<const T*>(Jk), static_cast<const T*>(rw), C, O, opt_k,
        static_cast<const int*>(fx_sh), static_cast<unsigned long long*>(fx_acc));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ba_finish_kernel<B, T><<<((B * B + B) * C + 20 + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const unsigned long long*>(fx_acc), static_cast<const int*>(fx_sh), C,
      static_cast<const T*>(U_extra), static_cast<const T*>(g_c_extra), static_cast<T*>(U),
      static_cast<T*>(g_c), static_cast<T*>(Uk), static_cast<T*>(g_k));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > 0) {
    ba_point_kernel<T><<<(G + NT - 1) / NT, NT, 0, st>>>(
        static_cast<const int*>(obs_point), static_cast<const int*>(perm),
        static_cast<const uint8_t*>(perm_valid), G, Vs, static_cast<const T*>(Jp),
        static_cast<const T*>(rw), static_cast<T*>(V), static_cast<T*>(g_p));
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool PERCAM>
int ba_cost(const void* rvec, const void* tvec, const void* intr, const void* points,
            const void* obs_cam, const void* obs_point, const void* obs_xy, const void* obs_w,
            int O, float delta, void* out, void* partial, cudaStream_t st) {
  // partial: COST_BLOCKS doubles of scratch.
  if (O > 0) {
    const int grid = min((O + NT - 1) / NT, COST_BLOCKS);
    ba_cost_kernel<PERCAM><<<grid, NT, 0, st>>>(
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
  (void)P;
  return ba_linearize<6, float>(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w,
                                cam_free, point_valid, perm, perm_valid, C, O, G, Vs, delta,
                                opt_k, Jc, Jk, Jp, rw, U, g_c, Uk, g_k, V, g_p, fx_max, fx_sh,
                                fx_acc, nullptr, nullptr, static_cast<cudaStream_t>(stream));
}

// The other routes: B = 10 (intr (C, 4), U_extra (C, 10, 10) and g_c_extra
// (C, 10), or null) and the f64 island (T = double outputs and scratch).
#define SFM_BA_LINEARIZE_VARIANT(NAME, B, T)                                                  \
  SFM_API int NAME(const void* rvec, const void* tvec, const void* intr, const void* points,   \
                   const void* obs_cam, const void* obs_point, const void* obs_xy,            \
                   const void* obs_w, const void* cam_free, const void* point_valid,          \
                   const void* perm, const void* perm_valid, int C, int P, int O, int G,      \
                   int Vs, float delta, int opt_k, void* Jc, void* Jk, void* Jp, void* rw,    \
                   void* U, void* g_c, void* Uk, void* g_k, void* V, void* g_p, void* fx_max, \
                   void* fx_sh, void* fx_acc, const void* U_extra, const void* g_c_extra,     \
                   void* stream) {                                                            \
    (void)P;                                                                                  \
    return ba_linearize<B, T>(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w,    \
                              cam_free, point_valid, perm, perm_valid, C, O, G, Vs, delta,    \
                              opt_k, Jc, Jk, Jp, rw, U, g_c, Uk, g_k, V, g_p, fx_max, fx_sh,  \
                              fx_acc, U_extra, g_c_extra, static_cast<cudaStream_t>(stream)); \
  }
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_b10, 10, float)
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_f64, 6, double)
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_b10_f64, 10, double)
#undef SFM_BA_LINEARIZE_VARIANT

SFM_API int sfm_ba_cost(const void* rvec, const void* tvec, const void* intr,
                        const void* points, const void* obs_cam, const void* obs_point,
                        const void* obs_xy, const void* obs_w, int O, float delta,
                        void* out, void* partial, void* stream) {
  return ba_cost<false>(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, O, delta,
                        out, partial, static_cast<cudaStream_t>(stream));
}

// The cost with each camera's own intrinsics (intr (C, 4)).
SFM_API int sfm_ba_cost_b10(const void* rvec, const void* tvec, const void* intr,
                            const void* points, const void* obs_cam, const void* obs_point,
                            const void* obs_xy, const void* obs_w, int O, float delta,
                            void* out, void* partial, void* stream) {
  return ba_cost<true>(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, O, delta,
                       out, partial, static_cast<cudaStream_t>(stream));
}
