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
// sfm_ba_linearize launches two kernels over a layout that ba/schur.py
// builds once a BA problem (linearize_layout): the grouping's valid rows in
// camera-major order, cut into chunks of one camera each (camera, start,
// end, the camera's number of chunks), the rows outside the grouping (dead:
// obs_w = 0) and the points that no grouping row holds.
//  1. The row pass, a block a chunk, a thread a row: Rodrigues with the
//     theta^2 < 1e-8 Taylor branch of rotations.py::rodrigues, the projection,
//     the residual, the analytic Jacobians (the derivative of that same
//     branch, so rvec = 0 -- the seed camera -- gives finite values), the
//     Huber weight and the whitening sqrt(w * obs_w) * cam_free (camera) /
//     * point_valid (point); the whitened Jc, Jk, Jp, rw (read by K10 and the
//     back-substitution) written at the row's own index. The largest |entry|
//     of the camera's Jc columns and residuals, and of Jk's columns, is
//     reduced in the block and met in global memory with one atomic max a
//     (chunk, column). The blocks past the chunks write the dead rows' zeros.
//     At B = 10 in f32 the row pass is the first design's kernel
//     (ba_obs_kernel: a thread a row over all rows, an atomic max a row and
//     camera column), its text unchanged, for the bits: see there.
//  2. The sum pass, a block a chunk: the camera's and the intrinsics' shifts
//     of the order-free sums (sfm_common.cuh) from those maxima and the row
//     count (a term is at most max_i * max_j, two rows an observation); the
//     chunk's rows staged in shared memory; a thread a (target, row lane),
//     the targets being U's upper triangle and g_c (the camera's), Uk's
//     upper triangle and g_k (the shared intrinsics'), each term quantized
//     and summed in the thread's registers, the lanes' sums met in shared
//     memory and added with one global atomic a (chunk, target, word). The
//     camera's last chunk to arrive (a fenced ticket a camera) rounds its
//     sums to T, mirrors U, adds U_extra / g_c_extra (the per-camera
//     intrinsics regularization) and clears them; the last chunk of all does
//     the same for Uk and g_k. At B = 6 a camera whose cam_free is 0 has zero
//     columns and no camera sums; at B = 10 its four intrinsics columns are
//     summed (its pose columns are zero). The blocks past the chunks are the
//     point side: V and g_p, a grouping row each (schur.py::coobs_pairs), a
//     plain loop over the point's observations, no atomics; zeros for the
//     points no row holds.
// The maxima, sums and tickets live in the caller's workspace and are zero
// between calls (the kernels leave them so): no memset, no per-call scratch.
// Every term keeps the expression, operands and shift it had when the sums
// were scattered a row at a time, and integer sums do not depend on their
// order, so every grouping and grid gives the same bits (float atomics did
// not: the LM path, and the incremental engine's registrations after it,
// changed from run to run).
// sfm_ba_cost: the Huber cost of every row with obs_w > 0 (the LM accept
// test), each block's f64 sum written to its slot, then the slots added in
// order by one warp: deterministic, with a grid that does not depend on the
// card's SM count.
//
// What bounds it on the H100: ~400 FLOP per observation (200k rows: 80 MFLOP)
// and ~140 bytes written per row (28 MB); both are microseconds, so the
// launches and the sums' atomics and staging set the time. The design keeps
// one atomic a (chunk, target) where the first one took one a (row, target)
// (27 a row at B = 6, 65 at B = 10, twice that in f64; ~2,000 rows of a
// camera met on the same words at L2), and the scratch and its clearing in
// the kernels where the first one took two memsets and three more launches.
// The model's bits are the first design's, so the row arithmetic must compile
// to its SASS: nvcc leaves some products and sums as mul.f32 / add.f32 in
// PTX, and ptxas fuses such a pair into an FFMA only where the product has
// one use. The chunked row pass reads its camera a row at a time through an
// index the compiler cannot see through (hoisted, the camera's arithmetic
// contracted otherwise); its FFMA / FMUL / FADD counts are the first
// design's on three routes, and ba_obs_kernel is kept for the fourth.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int COST_BLOCKS = 512;  // the cost's partial sums (a fixed grid)
constexpr int NK = 10 + 4;        // Uk's upper triangle + g_k
constexpr int REST_BLOCKS = 132;  // the row pass's blocks for the dead rows, at most

// A camera's fixed-point sums: U's upper triangle (NU), then g_c (B); and its
// maxima: Jc's B columns, then rw.
template <int B>
struct Cam {
  static constexpr int NU = B * (B + 1) / 2;
  static constexpr int NCAM = NU + B;
  static constexpr int CMAX = B + 1;
};

// A row as the sum pass stages it: Jc (2 x B), rw (2), Jk (2 x 4); an odd
// stride, so that the rows a warp stages fall in different banks.
template <int B>
struct Rec {
  static constexpr int RW = 2 * B, JK = 2 * B + 2, N = 2 * B + 10, STRIDE = N + 1;
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

// N values of a row to or from device memory, 16 bytes a transfer where the
// row's size allows (then its address does too), else 8 (float rows only).
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st8(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  v[0] = a.x; v[1] = a.y;
}

template <int N, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, const T* v) {
  constexpr int E16 = 16 / sizeof(T), E8 = 8 / sizeof(T);
  if constexpr (N % E16 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += E16) st16(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += E8) st8(p + i, v + i);
  }
}

template <int N, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T* v) {
  constexpr int E16 = 16 / sizeof(T), E8 = 8 / sizeof(T);
  if constexpr (N % E16 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += E16) ld16(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += E8) ld8(p + i, v + i);
  }
}

// The row pass (see the header). cmax: C x (B + 1), kmax: 5 (Jk's columns,
// then rw), both the float bits of the largest |entry|.
template <int B, typename T>
__global__ void __launch_bounds__(NT) lin_row_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const int* __restrict__ obs_point, const float* __restrict__ obs_xy,
    const float* __restrict__ obs_w, const float* __restrict__ cam_free,
    const uint8_t* __restrict__ point_valid, const int* __restrict__ rows,
    const int4* __restrict__ chunks, int n_chunks, const int* __restrict__ rest, int n_rest,
    float delta, int opt_k, T* __restrict__ Jc_out, T* __restrict__ Jk_out,
    T* __restrict__ Jp_out, T* __restrict__ rw_out, unsigned int* __restrict__ cmax,
    unsigned int* __restrict__ kmax) {
  constexpr int CMAX = Cam<B>::CMAX, NM = CMAX + 5;
  if (blockIdx.x >= n_chunks) {  // the rows outside the grouping: dead, zeros
    T z[2 * B];
#pragma unroll
    for (int j = 0; j < 2 * B; ++j) z[j] = T(0);
    const int step = (gridDim.x - n_chunks) * NT;
    for (int i = (blockIdx.x - n_chunks) * NT + threadIdx.x; i < n_rest; i += step) {
      const size_t o = rest[i];
      store_row<2 * B>(Jc_out + o * 2 * B, z);
      store_row<8>(Jk_out + o * 8, z);
      store_row<6>(Jp_out + o * 6, z);
      store_row<2>(rw_out + o * 2, z);
    }
    return;
  }
  __shared__ unsigned int s_max[NT / 32][NM];
  const int4 ch = chunks[blockIdx.x];  // camera, start, end, the camera's chunks
  const int c = ch.x;
  float in_k[4];  // the shared K (B = 6); B = 10 reads each camera's own
  if (B == 6)
    for (int j = 0; j < 4; ++j) in_k[j] = intr[j];
  const bool cam_on = B == 10 || (c >= 0 && cam_free[c] != 0.f);
  unsigned int m[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) m[j] = 0u;
  for (int i = ch.y + threadIdx.x; i < ch.z; i += NT) {
    const int o = rows[i];
    const float wv = obs_w[o];
    T jc[2 * B], jk[8], jp[6];
    T rw[2] = {T(0), T(0)};
    if (wv != 0.f) {
      // The camera is read a row at a time, through a copy of its index that
      // the compiler cannot see through: its part of the arithmetic then
      // stays in the row's code, fused into FMAs as the first design's was,
      // instead of being hoisted out of the loop (see the header).
      int cr = c;
      asm volatile("" : "+r"(cr));
      const int p = obs_point[o];
      Obs ob;
      residual_jac<true>(rvec + 3 * cr, tvec + 3 * cr, B == 6 ? in_k : intr + 4 * cr,
                         points + 3 * p, obs_xy[2 * o], obs_xy[2 * o + 1], &ob);
      const float nrm = sqrtf(ob.r[0] * ob.r[0] + ob.r[1] * ob.r[1]);
      const float hw = nrm <= delta ? 1.f : delta / fmaxf(nrm, 1e-12f);
      T sw;
      whiten_scale(hw, wv, &sw);
      const T sc = sw * (T)cam_free[cr], sp = sw * (T)(point_valid[p] != 0 ? 1.f : 0.f),
              sk_ = opt_k ? sw : T(0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rw[r] = (T)ob.r[r] * sw;
#pragma unroll
        for (int j = 0; j < 6; ++j) jc[r * B + j] = (T)ob.Jc[r][j] * sc;
#pragma unroll
        for (int j = 6; j < B; ++j) jc[r * B + j] = (T)ob.Jk[r][j - 6] * sw;
#pragma unroll
        for (int j = 0; j < 4; ++j) jk[r * 4 + j] = (T)ob.Jk[r][j] * sk_;
#pragma unroll
        for (int j = 0; j < 3; ++j) jp[r * 3 + j] = (T)ob.Jp[r][j] * sp;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * B; ++j) jc[j] = T(0);
#pragma unroll
      for (int j = 0; j < 8; ++j) jk[j] = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) jp[j] = T(0);
    }
    store_row<2 * B>(Jc_out + (size_t)o * 2 * B, jc);
    store_row<8>(Jk_out + (size_t)o * 8, jk);
    store_row<6>(Jp_out + (size_t)o * 6, jp);
    store_row<2>(rw_out + (size_t)o * 2, rw);
    const unsigned int rmax = sfm_fx_mag(t_max(t_abs(rw[0]), t_abs(rw[1])));
    if (wv != 0.f && cam_on) {
#pragma unroll
      for (int j = 0; j < B; ++j)
        m[j] = max(m[j], sfm_fx_mag(t_max(t_abs(jc[j]), t_abs(jc[B + j]))));
      m[B] = max(m[B], rmax);
    }
    if (opt_k) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        m[CMAX + j] = max(m[CMAX + j], sfm_fx_mag(t_max(t_abs(jk[j]), t_abs(jk[4 + j]))));
      m[CMAX + 4] = max(m[CMAX + 4], rmax);
    }
  }
  // The chunk's maxima: a warp's, then the warps' in shared memory, then one
  // atomic a column.
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    const unsigned int b = __reduce_max_sync(0xffffffffu, m[j]);
    if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32][j] = b;
  }
  __syncthreads();
  if (threadIdx.x < NM) {
    unsigned int b = 0u;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) b = max(b, s_max[i][threadIdx.x]);
    if (b != 0u)
      atomicMax(threadIdx.x < CMAX ? &cmax[c * CMAX + threadIdx.x] : &kmax[threadIdx.x - CMAX], b);
  }
}

// The row pass of the per-camera intrinsics route in f32 (B = 10, float):
// the first design's kernel, its text unchanged, a thread a row over all O
// rows with an atomic max a row and camera column, so that its SASS is the
// first design's. At this instantiation the chunked row pass above shares
// theta^2's w1 * w1 with R's, where this kernel computes it twice (a
// single-use product that ptxas fuses into an FFMA): on rotations of ~0.4 rad
// R moved by an ulp and a 300-view model by 0.006 px.
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

int grid_for(int O) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(1, min((O + NT - 1) / NT, 4 * sms));
}


// V and g_p of grouping row idx (< G), or the zeros of the (idx - G)-th point
// that no grouping row holds.
template <typename T>
__device__ __forceinline__ void point_side(int idx, const int* __restrict__ obs_point,
                                           const int* __restrict__ perm,
                                           const uint8_t* __restrict__ perm_valid, int G,
                                           int Vs, const int* __restrict__ orphans,
                                           int n_orphans, const T* __restrict__ Jp,
                                           const T* __restrict__ rw, T* __restrict__ V,
                                           T* __restrict__ g_p) {
  if (idx >= G) {
    if (idx - G >= n_orphans) return;
    const size_t p = orphans[idx - G];
    for (int k = 0; k < 9; ++k) V[p * 9 + k] = T(0);
    for (int k = 0; k < 3; ++k) g_p[p * 3 + k] = T(0);
    return;
  }
  const int g = idx;
  if (!perm_valid[(size_t)g * Vs]) return;
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

// The sum pass and the point side (see the header). acc holds WORDS x nfx
// words, nfx = C x NCAM (the cameras' targets) + 14 (the intrinsics');
// tickets C + 1 (a camera's chunks arrived, then all chunks).
template <int B, typename T>
__global__ void __launch_bounds__(NT) lin_sum_kernel(
    const T* __restrict__ Jc, const T* __restrict__ Jk, const T* __restrict__ rw,
    const float* __restrict__ cam_free, const int* __restrict__ rows,
    const int4* __restrict__ chunks, int n_chunks, int C, double nrows, int opt_k,
    unsigned int* __restrict__ cmax, unsigned int* __restrict__ kmax,
    unsigned long long* __restrict__ acc, unsigned int* __restrict__ tickets,
    const T* __restrict__ U_extra, const T* __restrict__ g_c_extra, T* __restrict__ U,
    T* __restrict__ g_c, T* __restrict__ Uk, T* __restrict__ g_k,
    const int* __restrict__ obs_point, const int* __restrict__ perm,
    const uint8_t* __restrict__ perm_valid, int G, int Vs, const int* __restrict__ orphans,
    int n_orphans, const T* __restrict__ Jp, T* __restrict__ V, T* __restrict__ g_p) {
  using R = Rec<B>;
  constexpr int NU = Cam<B>::NU, NCAM = Cam<B>::NCAM, CMAX = Cam<B>::CMAX;
  constexpr int W = SfmFx<T>::WORDS;
  constexpr int TILE = NT * 4 / (int)sizeof(T);  // rows staged at a time: 256 / 128
  if (blockIdx.x >= n_chunks) {
    point_side<T>((blockIdx.x - n_chunks) * NT + threadIdx.x, obs_point, perm, perm_valid, G,
                  Vs, orphans, n_orphans, Jp, rw, V, g_p);
    return;
  }
  __shared__ T s_rec[TILE * R::STRIDE];
  __shared__ unsigned long long s_part[W * NT];
  __shared__ int s_sh[NCAM + NK];
  __shared__ double s_val[NCAM + NK];
  __shared__ unsigned int s_last;
  const size_t nfx = (size_t)NCAM * C + NK;
  const int4 ch = chunks[blockIdx.x];
  const int c = ch.x;
  const bool cam_on = c >= 0 && (B == 10 || cam_free[c] != 0.f);
  const int n_cam = cam_on ? NCAM : 0, n_t = n_cam + (opt_k ? NK : 0);
  // The shifts: the camera's targets, then the intrinsics' (from the maxima
  // the row pass met, and the row count).
  for (int e = threadIdx.x; e < NCAM + NK; e += NT) {
    const unsigned int* m = kmax;
    int i = 4, j = e - NCAM - 10;
    if (e < NCAM) {
      if (c < 0) continue;
      m = cmax + c * CMAX;
      i = B;
      j = e - NU;
      if (e < NU) upper_ij(e, B, i, j);
    } else if (e - NCAM < 10) {
      upper_ij(e - NCAM, 4, i, j);
    }
    const double b = (double)__uint_as_float(m[i]) * (double)__uint_as_float(m[j]);
    s_sh[e] = sfm_fx_shift_t<T>(b * nrows);
  }
  // This thread's target tg and row lane lr: x = s[p0] s[p1] + s[p2] s[p3] of
  // every staged row lr, lr + per, ...
  const int per = n_t > 0 ? NT / n_t : 0;
  const int tg = n_t > 0 ? (int)threadIdx.x % n_t : 0, lr = n_t > 0 ? (int)threadIdx.x / n_t : 0;
  const bool act = lr < per;
  int p0 = 0, p1 = 0, p2 = 0, p3 = 0;
  if (tg < n_cam) {
    if (tg < NU) {
      int i, j;
      upper_ij(tg, B, i, j);
      p0 = i; p1 = j; p2 = B + i; p3 = B + j;
    } else {
      p0 = tg - NU; p1 = R::RW; p2 = B + tg - NU; p3 = R::RW + 1;
    }
  } else {
    const int q = tg - n_cam;
    if (q < 10) {
      int i, j;
      upper_ij(q, 4, i, j);
      p0 = R::JK + i; p1 = R::JK + j; p2 = R::JK + 4 + i; p3 = R::JK + 4 + j;
    } else {
      p0 = R::JK + q - 10; p1 = R::RW; p2 = R::JK + 4 + q - 10; p3 = R::RW + 1;
    }
  }
  __syncthreads();
  const int sh = act ? s_sh[tg < n_cam ? tg : NCAM + tg - n_cam] : SFM_FX_BAD;
  unsigned long long hi = 0ull, lo = 0ull;
  for (int t0 = ch.y; n_t > 0 && t0 < ch.z; t0 += TILE) {
    const int n = min(TILE, ch.z - t0);
    if ((int)threadIdx.x < n) {
      const size_t o = rows[t0 + threadIdx.x];
      T v[R::N];
      load_row<2 * B>(Jc + o * 2 * B, v);
      load_row<2>(rw + o * 2, v + R::RW);
      load_row<8>(Jk + o * 8, v + R::JK);
#pragma unroll
      for (int q = 0; q < R::N; ++q) s_rec[threadIdx.x * R::STRIDE + q] = v[q];
    }
    __syncthreads();
    if (sh != SFM_FX_BAD) {
      for (int r = lr; r < n; r += per) {
        const T* s = s_rec + r * R::STRIDE;
        const T x = s[p0] * s[p1] + s[p2] * s[p3];
        const SfmFxQ q = sfm_fx_q(x, sh);
        hi += static_cast<unsigned long long>(q.hi);
        if (W == 2) lo += static_cast<unsigned long long>(q.lo);
      }
    }
    __syncthreads();
  }
  // The row lanes' sums of a target met in shared memory (integers: any
  // order gives the same bits), then one atomic a (target, word).
  s_part[threadIdx.x] = hi;
  if (W == 2) s_part[NT + threadIdx.x] = lo;
  __syncthreads();
  for (int e = threadIdx.x; e < W * n_t; e += NT) {
    const int k = e % n_t, word = e / n_t;
    unsigned long long s = 0ull;
    for (int l = 0; l < per; ++l) s += s_part[word * NT + l * n_t + k];
    if (s != 0ull) {
      const size_t idx = k < n_cam ? (size_t)c * NCAM + k : (size_t)NCAM * C + (k - n_cam);
      atomicAdd(&acc[word * nfx + idx], s);
    }
  }
  // The camera's last chunk, and the last chunk of all, take what the
  // others added (a fenced ticket), round it and clear the scratch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int last = 0u;
    if (c >= 0 && atomicAdd(&tickets[c], 1u) == (unsigned int)ch.w - 1u) last |= 1u;
    if (atomicAdd(&tickets[C], 1u) == (unsigned int)n_chunks - 1u) last |= 2u;
    s_last = last;
  }
  __syncthreads();
  const unsigned int last = s_last;
  if (last == 0u) return;
  __threadfence();
  // Read from L2 (__ldcg): the other blocks' atomics are there, not in this L1.
  for (int k = threadIdx.x; k < NCAM + NK; k += NT) {
    const bool cam = k < NCAM;
    if (!(last & (cam ? 1u : 2u))) continue;
    const size_t idx = cam ? (size_t)c * NCAM + k : (size_t)NCAM * C + (k - NCAM);
    const unsigned long long h = __ldcg(acc + idx);
    s_val[k] = W == 1 ? sfm_fx_value(h, s_sh[k])
                      : sfm_fx_value2(h, __ldcg(acc + nfx + idx), s_sh[k]);
    acc[idx] = 0ull;
    if (W == 2) acc[nfx + idx] = 0ull;
  }
  if ((last & 1u) && threadIdx.x < CMAX) cmax[c * CMAX + threadIdx.x] = 0u;
  if ((last & 2u) && threadIdx.x < 5) kmax[threadIdx.x] = 0u;
  __syncthreads();
  if (last & 1u) {
    for (int e = threadIdx.x; e < B * B + B; e += NT) {
      if (e < B * B) {
        const int r = e / B, col = e % B, i = min(r, col), j = max(r, col);
        const T v = (T)s_val[i * B - i * (i - 1) / 2 + (j - i)];
        const size_t u = (size_t)c * B * B + e;
        U[u] = U_extra != nullptr ? v + U_extra[u] : v;
      } else {
        const int i = e - B * B;
        const T v = (T)s_val[NU + i];
        const size_t u = (size_t)c * B + i;
        g_c[u] = g_c_extra != nullptr ? v + g_c_extra[u] : v;
      }
    }
    if (threadIdx.x == 0) tickets[c] = 0u;
  }
  if (last & 2u) {
    if (threadIdx.x < 16) {
      const int r = threadIdx.x / 4, col = threadIdx.x % 4, i = min(r, col), j = max(r, col);
      Uk[threadIdx.x] = (T)s_val[NCAM + i * 4 - i * (i - 1) / 2 + (j - i)];
    } else if (threadIdx.x < 20) {
      g_k[threadIdx.x - 16] = (T)s_val[NCAM + 10 + threadIdx.x - 16];
    }
    if (threadIdx.x == 0) tickets[C] = 0u;
  }
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

// The layout (ba/schur.py::linearize_layout): rows (the grouping's valid
// rows, camera-major), chunks (n_chunks int4: camera, start, end, the
// camera's chunks), rest (the other rows), orphans (the points no grouping
// row holds). Scratch, zero between calls: cmax C x (B + 1) + 5 uint32, acc
// WORDS x (C x (B (B + 1) / 2 + B) + 14) uint64, tickets C + 1 uint32.
template <int B, typename T>
int ba_linearize(const void* rvec, const void* tvec, const void* intr, const void* points,
                 const void* obs_cam, const void* obs_point, const void* obs_xy,
                 const void* obs_w, const void* cam_free, const void* point_valid,
                 const void* point_valid_f, const void* perm,
                 const void* perm_valid, const void* rows, const void* chunks, const void* rest,
                 const void* orphans, int C, int O, int G, int Vs, int n_chunks, int n_rest,
                 int n_orphans, float delta, int opt_k, void* Jc, void* Jk, void* Jp, void* rw,
                 void* U, void* g_c, void* Uk, void* g_k, void* V, void* g_p, void* cmax,
                 void* acc, void* tickets, const void* U_extra, const void* g_c_extra,
                 cudaStream_t st) {
  if (n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int CMAX = Cam<B>::CMAX;
  unsigned int* cm = static_cast<unsigned int*>(cmax);
  const int4* ch = static_cast<const int4*>(chunks);
  if constexpr (B == 10 && sizeof(T) == sizeof(float)) {
    if (O > 0) {
      ba_obs_kernel<B, T><<<grid_for(O), NT, 0, st>>>(
          static_cast<const float*>(rvec), static_cast<const float*>(tvec),
          static_cast<const float*>(intr), static_cast<const float*>(points),
          static_cast<const int*>(obs_cam), static_cast<const int*>(obs_point),
          static_cast<const float*>(obs_xy), static_cast<const float*>(obs_w),
          static_cast<const float*>(cam_free), static_cast<const float*>(point_valid_f), C, O,
          delta, opt_k, static_cast<T*>(Jc), static_cast<T*>(Jk), static_cast<T*>(Jp),
          static_cast<T*>(rw), cm, cm + CMAX * C);
    }
  } else {
    const int rest_blocks = min((n_rest + NT - 1) / NT, REST_BLOCKS);
    lin_row_kernel<B, T><<<n_chunks + rest_blocks, NT, 0, st>>>(
        static_cast<const float*>(rvec), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const int*>(obs_point), static_cast<const float*>(obs_xy),
        static_cast<const float*>(obs_w), static_cast<const float*>(cam_free),
        static_cast<const uint8_t*>(point_valid), static_cast<const int*>(rows), ch, n_chunks,
        static_cast<const int*>(rest), n_rest, delta, opt_k, static_cast<T*>(Jc),
        static_cast<T*>(Jk), static_cast<T*>(Jp), static_cast<T*>(rw), cm, cm + CMAX * C);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int point_blocks = (G + n_orphans + NT - 1) / NT;
  lin_sum_kernel<B, T><<<n_chunks + point_blocks, NT, 0, st>>>(
      static_cast<const T*>(Jc), static_cast<const T*>(Jk), static_cast<const T*>(rw),
      static_cast<const float*>(cam_free), static_cast<const int*>(rows), ch, n_chunks, C,
      2.0 * (double)O, opt_k, cm, cm + CMAX * C, static_cast<unsigned long long*>(acc),
      static_cast<unsigned int*>(tickets), static_cast<const T*>(U_extra),
      static_cast<const T*>(g_c_extra), static_cast<T*>(U), static_cast<T*>(g_c),
      static_cast<T*>(Uk), static_cast<T*>(g_k), static_cast<const int*>(obs_point),
      static_cast<const int*>(perm), static_cast<const uint8_t*>(perm_valid), G, Vs,
      static_cast<const int*>(orphans), n_orphans, static_cast<const T*>(Jp),
      static_cast<T*>(V), static_cast<T*>(g_p));
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

// The default route and the others: B = 10 (intr (C, 4), U_extra (C, 10, 10)
// and g_c_extra (C, 10), or null) and the f64 island (T = double outputs and
// sums); the default route takes no U_extra / g_c_extra.
#define SFM_BA_LINEARIZE_ARGS                                                                  \
  const void *rvec, const void *tvec, const void *intr, const void *points,                   \
      const void *obs_cam, const void *obs_point, const void *obs_xy, const void *obs_w,      \
      const void *cam_free, const void *point_valid, const void *point_valid_f,               \
      const void *perm, const void *perm_valid, const void *rows,                              \
      const void *chunks, const void *rest, const void *orphans, int C, int O, int G, int Vs, \
      int n_chunks, int n_rest, int n_orphans, float delta, int opt_k, void *Jc, void *Jk,    \
      void *Jp, void *rw, void *U, void *g_c, void *Uk, void *g_k, void *V, void *g_p,        \
      void *cmax, void *acc, void *tickets
#define SFM_BA_LINEARIZE_CALL(B, T, U_EXTRA, G_C_EXTRA)                                        \
  ba_linearize<B, T>(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, cam_free,   \
                     point_valid, point_valid_f, perm, perm_valid, rows, chunks, rest,        \
                     orphans, C, O, G, Vs,                                                    \
                     n_chunks, n_rest, n_orphans, delta, opt_k, Jc, Jk, Jp, rw, U, g_c, Uk,   \
                     g_k, V, g_p, cmax, acc, tickets, U_EXTRA, G_C_EXTRA,                     \
                     static_cast<cudaStream_t>(stream))

SFM_API int sfm_ba_linearize(SFM_BA_LINEARIZE_ARGS, void* stream) {
  return SFM_BA_LINEARIZE_CALL(6, float, nullptr, nullptr);
}

#define SFM_BA_LINEARIZE_VARIANT(NAME, B, T)                                                  \
  SFM_API int NAME(SFM_BA_LINEARIZE_ARGS, const void* U_extra, const void* g_c_extra,         \
                   void* stream) {                                                            \
    return SFM_BA_LINEARIZE_CALL(B, T, U_extra, g_c_extra);                                   \
  }
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_b10, 10, float)
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_f64, 6, double)
SFM_BA_LINEARIZE_VARIANT(sfm_ba_linearize_b10_f64, 10, double)
#undef SFM_BA_LINEARIZE_VARIANT
#undef SFM_BA_LINEARIZE_CALL
#undef SFM_BA_LINEARIZE_ARGS

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
