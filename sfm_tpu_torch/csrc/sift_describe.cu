// Kernel K5: SIFT orientation + 128-D descriptor per keypoint, from the f16 canvas.
//
// Replaces sfm_tpu/features/descriptor.py::orientation_and_descriptor_canvas
// (extract_grad_patch_canvas, keypoint_orientation_patch and
// keypoint_descriptor_patch, vmapped over keypoints). The TPU program samples
// the gradient patch with one-hot row/column matmuls (an MXU idiom for bilinear
// interpolation) and builds both histograms as dense one-hot einsums; here the
// four taps are read directly and the histograms are shared-memory atomics.
//
// What bounds it on the H100: per keypoint it reads one 66 x 66 f16 patch
// (8.7 KB) and does ~512 samples of a few dozen FLOPs plus ~2,600 shared-memory
// atomics; at 2048 keypoints per image that is latency of the atomics and the
// block's barriers rather than bandwidth or arithmetic.
//
// Design (simple first): one block of 256 threads per keypoint (one thread per
// sample). The block clamps the patch corner like lax.dynamic_slice, stages the
// patch in shared memory, takes the central differences in half precision (as
// the reference does on its f16 canvas) and widens them to f32 gradient patches
// in shared memory. Pass 1: 256 samples on the 16 x 16 orientation grid,
// soft-binned into a 36-bin histogram, two circular [1,4,6,4,1]/16 smoothings,
// first argmax + parabolic peak. Pass 2: 256 rotated samples on the descriptor
// grid, trilinear (2 x 2 spatial x 2 orientation) into the 4 x 4 x 8 histogram;
// then normalise, clip, renormalise. Products are rounded as the plain twin
// rounds them. The histograms are order-free 64-bit fixed-point sums
// (sfm_common.cuh; the bound is the block's sum of the sample weights),
// rounded to float once: the same bits every run, where float atomics would
// round in another order each time. They differ from the twin's sequential
// float sums in the last bits only.
#include "sfm_common.cuh"

namespace {

constexpr int PATCH = 64;
constexpr int GP = PATCH + 2;  // Gaussian patch incl. a 1-px border
constexpr int NT = 256;        // = samples per pass
constexpr int ORI_BINS = 36;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float PATCH_MAX = (float)(PATCH - 1.001);
// Offsets into the packed table (descriptor.py::_K5_TABLES).
constexpr int T_ORI_GRID = 0, T_ORI_W = 512, T_DESC_GRID = 768, T_DESC_WG = 1280,
              T_W_AXIS = 1536;

__device__ __forceinline__ float half_grad(__half hi, __half lo) {
  // 0.5 * (hi - lo) in half precision: each operation rounded to f16.
  const __half d = __float2half(__half2float(hi) - __half2float(lo));
  return __half2float(__float2half(0.5f * __half2float(d)));
}

// Bilinear sample of both 64 x 64 gradient patches at patch coords (xr, yr).
__device__ __forceinline__ bool sample(const float* gx, const float* gy, float xr,
                                       float yr, float& vx, float& vy) {
  const bool ok = xr >= 0.f && xr <= PATCH_MAX && yr >= 0.f && yr <= PATCH_MAX;
  const float xc = fminf(fmaxf(xr, 0.f), PATCH_MAX);
  const float yc = fminf(fmaxf(yr, 0.f), PATCH_MAX);
  const float x0 = floorf(xc), y0 = floorf(yc);
  const float fx = __fsub_rn(xc, x0), fy = __fsub_rn(yc, y0);
  const int i = (int)y0 * PATCH + (int)x0;
  vx = sfm_lerp_rn(sfm_lerp_rn(gx[i], gx[i + PATCH], fy),
                   sfm_lerp_rn(gx[i + 1], gx[i + PATCH + 1], fy), fx);
  vy = sfm_lerp_rn(sfm_lerp_rn(gy[i], gy[i + PATCH], fy),
                   sfm_lerp_rn(gy[i + 1], gy[i + PATCH + 1], fy), fx);
  return ok;
}

__device__ __forceinline__ float magnitude(float vx, float vy) {
  return sqrtf(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
}

// Sum of v over the block (all threads must call it).
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) s += red[i];
  return s;
}

__global__ void __launch_bounds__(NT) sift_describe_kernel(
    const __half* __restrict__ canvas, int S, int sumH, int Wmax,
    const int* __restrict__ grad_layer, const float* __restrict__ kx,
    const float* __restrict__ ky, const float* __restrict__ ksig,
    const int* __restrict__ row_off, const int* __restrict__ kw,
    const int* __restrict__ kh, int K, const float* __restrict__ tables,
    float descriptor_scale, float clip, float* __restrict__ angle_out,
    float* __restrict__ desc_out) {
  __shared__ __half patch[GP * GP];
  __shared__ float gx[PATCH * PATCH];
  __shared__ float gy[PATCH * PATCH];
  __shared__ float hist_a[ORI_BINS], hist_b[ORI_BINS];
  __shared__ unsigned long long fx_ori[ORI_BINS], fx_desc[128];
  __shared__ float red[NT / 32];
  __shared__ float s_angle;

  const int kp = blockIdx.x;
  const int b = kp / K;
  const int t = threadIdx.x;
  const float x = kx[kp], y = ky[kp], sig = ksig[kp];
  const int w_o = kw[kp], h_o = kh[kp];

  // Patch corner in octave coords, then the canvas slice start clamped like
  // lax.dynamic_slice.
  const int cx = (int)rintf(x), cy = (int)rintf(y);
  const int g0x = min(max(cx - (PATCH / 2 + 1), 0), max(w_o - GP, 0));
  const int g0y = min(max(cy - (PATCH / 2 + 1), 0), max(h_o - GP, 0));
  const int r0 = min(max(row_off[kp] + g0y, 0), sumH - GP);
  const int c0 = min(max(g0x, 0), Wmax - GP);
  const int lay = min(max(grad_layer[kp], 0), S - 1);
  const __half* src = canvas + ((size_t)b * S + lay) * sumH * Wmax;
  for (int e = t; e < GP * GP; e += NT)
    patch[e] = src[(size_t)(r0 + e / GP) * Wmax + c0 + e % GP];
  if (t < ORI_BINS) fx_ori[t] = 0ull;
  if (t < 128) fx_desc[t] = 0ull;
  __syncthreads();
  for (int e = t; e < PATCH * PATCH; e += NT) {
    const int r = e / PATCH, c = e % PATCH;
    gx[e] = half_grad(patch[(r + 1) * GP + c + 2], patch[(r + 1) * GP + c]);
    gy[e] = half_grad(patch[(r + 2) * GP + c + 1], patch[r * GP + c + 1]);
  }
  __syncthreads();

  const float sx = (float)(g0x + 1), sy = (float)(g0y + 1);
  const float xmax = (float)w_o - 1.001f, ymax = (float)h_o - 1.001f;

  // ---- pass 1: orientation ------------------------------------------------
  int sh = 0;
  {
    const float r = 4.5f * sig;
    const float xs = __fadd_rn(x, __fmul_rn(tables[T_ORI_GRID + 2 * t], r));
    const float ys = __fadd_rn(y, __fmul_rn(tables[T_ORI_GRID + 2 * t + 1], r));
    const bool inb = xs >= 0.f && xs <= xmax && ys >= 0.f && ys <= ymax;
    float vx, vy;
    const bool ok = sample(gx, gy, __fsub_rn(xs, sx), __fsub_rn(ys, sy), vx, vy);
    const float theta = sfm_pos_mod(atan2f(vy, vx), TWO_PI);
    const float wgt = (inb && ok) ? __fmul_rn(magnitude(vx, vy), tables[T_ORI_W + t]) : 0.f;
    const float bf = __fmul_rn(theta, (float)(ORI_BINS / 6.283185307179586));
    const float b0f = floorf(bf);
    const float frac = __fsub_rn(bf, b0f);
    const int b0 = sfm_pos_mod((int)b0f, ORI_BINS);
    sh = sfm_fx_shift((double)block_sum(wgt, red));
    sfm_fx_add(&fx_ori[b0], __fmul_rn(wgt, __fsub_rn(1.f, frac)), sh);
    sfm_fx_add(&fx_ori[(b0 + 1) % ORI_BINS], __fmul_rn(wgt, frac), sh);
  }
  __syncthreads();
  if (t < ORI_BINS) hist_a[t] = (float)sfm_fx_value(fx_ori[t], sh);
  float* h = hist_a;
  float* g = hist_b;
  for (int round = 0; round < 2; ++round) {
    __syncthreads();
    if (t < ORI_BINS) {
      const float near = __fadd_rn(h[(t + ORI_BINS - 1) % ORI_BINS], h[(t + 1) % ORI_BINS]);
      const float far = __fadd_rn(h[(t + ORI_BINS - 2) % ORI_BINS], h[(t + 2) % ORI_BINS]);
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(6.f, h[t]), __fmul_rn(4.f, near)), far);
      g[t] = __fdiv_rn(v, 16.f);
    }
    float* tmp = h;
    h = g;
    g = tmp;
  }
  __syncthreads();
  if (t == 0) {
    int p = 0;
    for (int i = 1; i < ORI_BINS; ++i)
      if (h[i] > h[p]) p = i;
    const float hl = h[(p + ORI_BINS - 1) % ORI_BINS], hc = h[p],
                hr = h[(p + 1) % ORI_BINS];
    const float denom = __fadd_rn(__fsub_rn(hl, __fmul_rn(2.f, hc)), hr);
    const float shift = fabsf(denom) < 1e-12f
                            ? 0.f
                            : __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(hl, hr)), denom);
    const float a = __fmul_rn(__fadd_rn(__fadd_rn((float)p, 0.5f), shift),
                              (float)(6.283185307179586 / ORI_BINS));
    s_angle = sfm_pos_mod(a, TWO_PI);
  }
  __syncthreads();
  const float angle = s_angle;

  // ---- pass 2: descriptor -------------------------------------------------
  {
    const float bin_size = __fmul_rn(descriptor_scale, sig);
    const float ca = cosf(angle), sa = sinf(angle);
    const float g0 = __fmul_rn(tables[T_DESC_GRID + 2 * t], bin_size);
    const float g1 = __fmul_rn(tables[T_DESC_GRID + 2 * t + 1], bin_size);
    const float xs = __fsub_rn(__fadd_rn(x, __fmul_rn(ca, g0)), __fmul_rn(sa, g1));
    const float ys = __fadd_rn(__fadd_rn(y, __fmul_rn(sa, g0)), __fmul_rn(ca, g1));
    const bool inb = xs >= 0.f && xs <= xmax && ys >= 0.f && ys <= ymax;
    float vx, vy;
    const bool ok = sample(gx, gy, __fsub_rn(xs, sx), __fsub_rn(ys, sy), vx, vy);
    const float theta = sfm_pos_mod(__fsub_rn(atan2f(vy, vx), angle), TWO_PI);
    const float bf = __fmul_rn(theta, (float)(8.0 / 6.283185307179586));
    const float b0f = floorf(bf);
    const float frac = __fsub_rn(bf, b0f);
    const int o0 = sfm_pos_mod((int)b0f, 8);
    const int o1 = (o0 + 1) % 8;
    const float contrib =
        (inb && ok) ? __fmul_rn(magnitude(vx, vy), tables[T_DESC_WG + t]) : 0.f;
    // The spatial weights are at most 1 each, so 16 x the contributions
    // bounds every bin.
    sh = sfm_fx_shift(16.0 * (double)block_sum(contrib, red));
    const float* wax = tables + T_W_AXIS;  // (16 samples per axis, 4 bins)
    const int i = t / 16, j = t % 16;      // sample row (y) and column (x)
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
      const float wy = wax[i * 4 + bi];
      if (wy == 0.f) continue;
#pragma unroll
      for (int bj = 0; bj < 4; ++bj) {
        const float wxv = wax[j * 4 + bj];
        if (wxv == 0.f) continue;
        const float base = __fmul_rn(__fmul_rn(wy, wxv), contrib);
        unsigned long long* cell = fx_desc + (bi * 4 + bj) * 8;
        sfm_fx_add(cell + o0, __fmul_rn(base, __fsub_rn(1.f, frac)), sh);
        sfm_fx_add(cell + o1, __fmul_rn(base, frac), sh);
      }
    }
  }
  __syncthreads();
  float v = t < 128 ? (float)sfm_fx_value(fx_desc[t], sh) : 0.f;
  const float n1 = fmaxf(sqrtf(block_sum(v * v, red)), 1e-12f);
  v = fminf(__fdiv_rn(v, n1), clip);
  const float n2 = fmaxf(sqrtf(block_sum(t < 128 ? v * v : 0.f, red)), 1e-12f);
  if (t < 128) desc_out[(size_t)kp * 128 + t] = __fdiv_rn(v, n2);
  if (t == 0) angle_out[kp] = angle;
}

}  // namespace

SFM_API int sfm_sift_describe(const void* canvas, int B, int S, int sumH,
                              int Wmax, const void* grad_layer, const void* x,
                              const void* y, const void* sigma_rel,
                              const void* row_off, const void* w_o,
                              const void* h_o, int K, const void* tables,
                              float descriptor_scale, float clip, void* angle,
                              void* desc, void* stream) {
  sift_describe_kernel<<<B * K, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __half*>(canvas), S, sumH, Wmax,
      static_cast<const int*>(grad_layer), static_cast<const float*>(x),
      static_cast<const float*>(y), static_cast<const float*>(sigma_rel),
      static_cast<const int*>(row_off), static_cast<const int*>(w_o),
      static_cast<const int*>(h_o), K, static_cast<const float*>(tables),
      descriptor_scale, clip, static_cast<float*>(angle),
      static_cast<float*>(desc));
  return static_cast<int>(cudaGetLastError());
}
