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
// (8.7 KB) and does 512 samples of a few dozen operations (their gradient
// taps, an atan2 each, 2 or 4 to 8 histogram atomics); at 24,576 keypoints a
// 12-image batch that is instruction issue and shared-memory latency, far from
// the bytes (0.07 ms a batch at 3.35 TB/s).
//
// Design: a warp a keypoint, two keypoints a block, and no block barrier: the
// warps never wait for each other. The warp stages its patch (the slice start
// clamped like lax.dynamic_slice) with cp.async copies of each row's aligned
// span (16 bytes where the canvas width is a multiple of 8 halves, else 4 or
// 2) into its own shared memory. No gradient plane is built: each sample takes
// the half-precision central differences (as the reference does on its f16
// canvas) at its four bilinear taps from the staged patch, two at a time
// (half2); a difference is a function of two halves, so a tap has the same
// bits wherever it is computed.
// Lane l takes samples l, l + 32, ..., l + 224 of each pass. Pass 1: the
// 16 x 16 orientation grid, soft-binned into a 36-bin histogram; the lanes
// take bins for the two circular [1,4,6,4,1]/16 smoothings, the first argmax
// (a warp reduction) and the parabolic peak. Pass 2: the rotated descriptor
// grid, trilinear (the two spatial bins of each axis x 2 orientations) into
// the 4 x 4 x 8 histogram; then normalise, clip, renormalise, a lane 4 bins.
// Every keypoint's outputs are written, valid or not.
//
// Bits: the histograms are order-free 64-bit fixed-point sums (sfm_common.cuh;
// the bound is the sum of the pass's sample weights), rounded to float once,
// so any lane order gives the same bits; each is kept as two 32-bit words
// with the low word's carries (native 32-bit shared atomics). The shift is the first design's: the
// warp sum of each group of 32 consecutive samples (an xor tree), then the 8
// group sums added in order from 0.f, as a block sum of 256 threads took it;
// the norms likewise over bins 0..127 and four zero groups. Every product and
// sum is spelled with the _rn intrinsics as the first design's compiled code
// rounded it, so the outputs are that design's to the bit. A term's fixed
// point is x * 2^sh in double: a shift from a float bound lies in [-71, 209],
// so for every finite float x the product is exact and equals ldexp(x, sh)
// (tests/test_torch_describe_retrieval_layout.py holds the range).
#include "cp_async.cuh"
#include "sfm_common.cuh"

#ifndef SFM_ST  // clock64 probes (tests/describe_stamps.py defines them)
#define SFM_ST_INIT(idx, on)
#define SFM_ST(slot)
#define SFM_ST_END
#endif

namespace {

constexpr int PATCH = 64;
constexpr int GP = PATCH + 2;  // Gaussian patch incl. a 1-px border
constexpr int STEPS = 8;       // a lane's samples a pass (256 / 32)
constexpr int ORI_BINS = 36;
constexpr int WARPS = 2;       // keypoints a block
constexpr int RS = 80;         // halves a staged row: 66 from a 16-byte-aligned start
constexpr float TWO_PI = 6.283185307179586f;
constexpr float PATCH_MAX = (float)(PATCH - 1.001);
// Offsets into the packed table (descriptor.py::_K5_TABLES).
constexpr int T_ORI_GRID = 0, T_ORI_W = 512, T_DESC_GRID = 768, T_DESC_WG = 1280,
              T_W_AXIS = 1536;

struct __align__(16) WarpSmem {
  __half patch[GP * RS];
  unsigned int fx_ori[2][ORI_BINS];  // the fixed-point sums' low and high words
  unsigned int fx_desc[2][128];
  float h[2][ORI_BINS];
};

// 0.5 * (hi - lo) in half precision, two at a time: each operation rounded to
// f16. The first design took the difference in float, then rounded it to f16;
// float's 24 bits are at least 2 x 11 + 2, so that double rounding is the
// single rounding of the exact difference that __hsub2 does (and 0.5 x is
// exact in float): the same bits (tests/test_torch_describe_retrieval_layout.py).
__device__ __forceinline__ __half2 half_grad2(__half2 hi, __half2 lo) {
  return __hmul2(__hsub2(hi, lo), __float2half2_rn(0.5f));
}

// Bilinear sample of both 64 x 64 gradient planes at patch coords (xr, yr),
// from the staged patch P (P(r, c) at P[r * RS + c]): the planes' entry (r, c)
// is gx = half_grad(P(r+1, c+2), P(r+1, c)), gy = half_grad(P(r+2, c+1),
// P(r, c+1)); the four taps read the 12 values of rows r..r+3, columns
// c..c+3 without the corners.
__device__ __forceinline__ bool sample(const __half* P, float xr, float yr, float& vx,
                                       float& vy) {
  const bool ok = xr >= 0.f && xr <= PATCH_MAX && yr >= 0.f && yr <= PATCH_MAX;
  const float xc = fminf(fmaxf(xr, 0.f), PATCH_MAX);
  const float yc = fminf(fmaxf(yr, 0.f), PATCH_MAX);
  const float x0 = floorf(xc), y0 = floorf(yc);
  const float fx = __fsub_rn(xc, x0), fy = __fsub_rn(yc, y0);
  const __half* Q = P + (int)y0 * RS + (int)x0;
  const __half a1 = Q[1], a2 = Q[2];
  const __half b0 = Q[RS], b1 = Q[RS + 1], b2 = Q[RS + 2], b3 = Q[RS + 3];
  const __half c0 = Q[2 * RS], c1 = Q[2 * RS + 1], c2 = Q[2 * RS + 2], c3 = Q[2 * RS + 3];
  const __half d1 = Q[3 * RS + 1], d2 = Q[3 * RS + 2];
  // (low, high) = the taps at rows r and r + 1, columns c, then c + 1.
  const __half2 gx0 = half_grad2(__halves2half2(b2, c2), __halves2half2(b0, c0));
  const __half2 gx1 = half_grad2(__halves2half2(b3, c3), __halves2half2(b1, c1));
  const __half2 gy0 = half_grad2(__halves2half2(c1, d1), __halves2half2(a1, b1));
  const __half2 gy1 = half_grad2(__halves2half2(c2, d2), __halves2half2(a2, b2));
  vx = sfm_lerp_rn(sfm_lerp_rn(__low2float(gx0), __high2float(gx0), fy),
                   sfm_lerp_rn(__low2float(gx1), __high2float(gx1), fy), fx);
  vy = sfm_lerp_rn(sfm_lerp_rn(__low2float(gy0), __high2float(gy0), fy),
                   sfm_lerp_rn(__low2float(gy1), __high2float(gy1), fy), fx);
  return ok;
}

__device__ __forceinline__ float magnitude(float vx, float vy) {
  return sqrtf(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
}

// sfm_pos_mod(a, 2 pi): fmodf(a, b) is a itself where |a| < b.
__device__ __forceinline__ float pos_mod_2pi(float a) {
  const float r = fabsf(a) < TWO_PI ? a : fmodf(a, TWO_PI);
  return r < 0.f ? r + TWO_PI : r;
}

// The warp's sum of v, the xor tree of a 32-thread group of the first design.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 2^sh (sh in [-1022, 1023]).
__device__ __forceinline__ double pow2(int sh) {
  return __longlong_as_double(static_cast<long long>(1023 + sh) << 52);
}

// Adds x's fixed point (sfm_fx_of(x, sh), as x * scale with scale = 2^sh) to
// a 64-bit sum kept as two 32-bit words, lo[0] and lo[n]: a 64-bit
// shared-memory atomic add is a compare-and-swap loop on the H100, a 32-bit
// one a native instruction. The low word's add returns the old word, so its
// carry goes into the high word exactly; the pair holds the 64-bit sum (mod
// 2^64) in any order.
__device__ __forceinline__ void fx_add(unsigned int* lo, int n, float x, double scale) {
  const long long v = __double2ll_rn(static_cast<double>(x) * scale);
  if (v == 0) return;
  const unsigned int vl = static_cast<unsigned int>(v);
  const unsigned int vh = static_cast<unsigned int>(static_cast<unsigned long long>(v) >> 32);
  unsigned int carry = 0;
  if (vl != 0) {
    const unsigned int old = atomicAdd(lo, vl);
    carry = old + vl < old;
  }
  if (vh + carry != 0) atomicAdd(lo + n, vh + carry);
}

// sfm_fx_value of the words lo[0], lo[n], rounded to float.
__device__ __forceinline__ float fx_value(const unsigned int* lo, int n, int sh) {
  if (sh == SFM_FX_BAD) return static_cast<float>(__longlong_as_double(0x7ff8000000000000ll));
  const unsigned long long acc = (static_cast<unsigned long long>(lo[n]) << 32) | lo[0];
  return static_cast<float>(static_cast<double>(static_cast<long long>(acc)) * pow2(-sh));
}

// The first of the (at most two, consecutive) spatial bins that sample
// position i (0..15) of an axis weighs: wax[i * 4 + lo] and, for lo < 3,
// wax[i * 4 + lo + 1] hold every nonzero weight of the row.
__device__ __forceinline__ int first_bin(const float* wax, int i) {
  int lo = 0;
  while (lo < 3 && __ldg(wax + i * 4 + lo) == 0.f) ++lo;
  return lo;
}

// E: halves a staging copy (8: 16 bytes, 2: 4 bytes, 1: a plain load).
template <int E>
__global__ void __launch_bounds__(WARPS * 32) sift_describe_kernel(
    const __half* __restrict__ canvas, int S, int sumH, int Wmax,
    const int* __restrict__ grad_layer, const float* __restrict__ kx,
    const float* __restrict__ ky, const float* __restrict__ ksig,
    const int* __restrict__ row_off, const int* __restrict__ kw,
    const int* __restrict__ kh, int K, int n_kp, const float* __restrict__ tables,
    float descriptor_scale, float clip, float* __restrict__ angle_out,
    float* __restrict__ desc_out) {
  __shared__ WarpSmem smem[WARPS];
  const int lane = threadIdx.x % 32;
  const int kp = blockIdx.x * WARPS + threadIdx.x / 32;
  if (kp >= n_kp) return;  // the whole warp: nothing below waits for another warp
  WarpSmem& sm = smem[threadIdx.x / 32];
  SFM_ST_INIT(kp, lane == 0)
  const int b = kp / K;
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
  const __half* src = canvas + (((size_t)b * S + lay) * sumH + r0) * Wmax;
  // Each row's span c0 .. c0 + 65 from the copy unit below it: n copies.
  const int a0 = c0 - c0 % E;
  const int n = (c0 + GP - a0 + E - 1) / E;
  for (int e = lane; e < GP * n; e += 32) {
    const int r = e / n, q = e - r * n;
    const __half* g = src + (size_t)r * Wmax + a0 + q * E;
    __half* d = sm.patch + r * RS + q * E;
    if constexpr (E == 8) {
      cp_async16(d, g);
    } else if constexpr (E == 2) {
      cp_async4(d, g);
    } else {
      *d = *g;
    }
  }
  for (int e = lane; e < ORI_BINS + 128; e += 32) {
    if (e < ORI_BINS) sm.fx_ori[0][e] = sm.fx_ori[1][e] = 0u;
    else sm.fx_desc[0][e - ORI_BINS] = sm.fx_desc[1][e - ORI_BINS] = 0u;
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  const __half* P = sm.patch + (c0 - a0);
  SFM_ST(0)

  const float sx = (float)(g0x + 1), sy = (float)(g0y + 1);
  const float xmax = (float)w_o - 1.001f, ymax = (float)h_o - 1.001f;

  // ---- pass 1: orientation ------------------------------------------------
  int sh;
  {
    float wgt[STEPS], frac[STEPS];
    int bin[STEPS];
    float sum = 0.f;
    const float r = __fmul_rn(4.5f, sig);
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int t = 32 * k + lane;
      const float xs = __fadd_rn(x, __fmul_rn(__ldg(tables + T_ORI_GRID + 2 * t), r));
      const float ys = __fadd_rn(y, __fmul_rn(__ldg(tables + T_ORI_GRID + 2 * t + 1), r));
      const bool inb = xs >= 0.f && xs <= xmax && ys >= 0.f && ys <= ymax;
      float vx, vy;
      const bool ok = sample(P, __fsub_rn(xs, sx), __fsub_rn(ys, sy), vx, vy);
      const float theta = pos_mod_2pi(atan2f(vy, vx));
      wgt[k] = (inb && ok) ? __fmul_rn(magnitude(vx, vy), __ldg(tables + T_ORI_W + t)) : 0.f;
      const float bf = __fmul_rn(theta, (float)(ORI_BINS / 6.283185307179586));
      const float b0f = floorf(bf);
      frac[k] = __fsub_rn(bf, b0f);
      bin[k] = sfm_pos_mod((int)b0f, ORI_BINS);
      sum += warp_sum(wgt[k]);
    }
    SFM_ST(7)
    sh = sfm_fx_shift((double)sum);
    if (sh != SFM_FX_BAD) {
      const double scale = pow2(sh);
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        fx_add(&sm.fx_ori[0][bin[k]], ORI_BINS, __fmul_rn(wgt[k], __fsub_rn(1.f, frac[k])),
               scale);
        fx_add(&sm.fx_ori[0][bin[k] == ORI_BINS - 1 ? 0 : bin[k] + 1], ORI_BINS,
               __fmul_rn(wgt[k], frac[k]), scale);
      }
    }
  }
  __syncwarp();
  SFM_ST(2)
  // Smoothing: lane l takes bin l, lanes 0..3 also bin 32 + l.
  sm.h[0][lane] = fx_value(&sm.fx_ori[0][lane], ORI_BINS, sh);
  if (lane < ORI_BINS - 32) sm.h[0][32 + lane] = fx_value(&sm.fx_ori[0][32 + lane], ORI_BINS, sh);
  __syncwarp();
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    const float* h = sm.h[round];
    float* g = sm.h[round ^ 1];
#pragma unroll
    for (int t = lane; t < ORI_BINS; t += 32) {
      const float near = __fadd_rn(h[(t + ORI_BINS - 1) % ORI_BINS], h[(t + 1) % ORI_BINS]);
      const float far = __fadd_rn(h[(t + ORI_BINS - 2) % ORI_BINS], h[(t + 2) % ORI_BINS]);
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(6.f, h[t]), __fmul_rn(4.f, near)), far);
      g[t] = __fdiv_rn(v, 16.f);
    }
    __syncwarp();
  }
  SFM_ST(3)
  // The first maximum (a serial scan from bin 0 with ">": NaN never wins, and
  // a NaN bin 0 is kept), then the parabolic peak, in every lane.
  const float* h = sm.h[0];
  float best = h[lane];
  int p = lane;
  if (best != best) best = -INFINITY;
  if (lane < ORI_BINS - 32 && h[32 + lane] > best) {
    best = h[32 + lane];
    p = 32 + lane;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int op = __shfl_xor_sync(0xffffffffu, p, off);
    if (ob > best || (ob == best && op < p)) {
      best = ob;
      p = op;
    }
  }
  if (h[0] != h[0]) p = 0;
  float angle;
  {
    const float hl = h[(p + ORI_BINS - 1) % ORI_BINS], hc = h[p], hr = h[(p + 1) % ORI_BINS];
    const float denom = __fadd_rn(__fsub_rn(hl, __fmul_rn(2.f, hc)), hr);
    const float shift = fabsf(denom) < 1e-12f
                            ? 0.f
                            : __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(hl, hr)), denom);
    const float a = __fmul_rn(__fadd_rn(__fadd_rn((float)p, 0.5f), shift),
                              (float)(6.283185307179586 / ORI_BINS));
    angle = pos_mod_2pi(a);
  }
  SFM_ST(4)

  // ---- pass 2: descriptor -------------------------------------------------
  {
    float contrib[STEPS], frac[STEPS];
    int ori[STEPS];
    float sum = 0.f;
    const float bin_size = __fmul_rn(descriptor_scale, sig);
    const float ca = cosf(angle), sa = sinf(angle);
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int t = 32 * k + lane;
      const float g0 = __fmul_rn(__ldg(tables + T_DESC_GRID + 2 * t), bin_size);
      const float g1 = __fmul_rn(__ldg(tables + T_DESC_GRID + 2 * t + 1), bin_size);
      const float xs = __fsub_rn(__fadd_rn(x, __fmul_rn(ca, g0)), __fmul_rn(sa, g1));
      const float ys = __fadd_rn(__fadd_rn(y, __fmul_rn(sa, g0)), __fmul_rn(ca, g1));
      const bool inb = xs >= 0.f && xs <= xmax && ys >= 0.f && ys <= ymax;
      float vx, vy;
      const bool ok = sample(P, __fsub_rn(xs, sx), __fsub_rn(ys, sy), vx, vy);
      const float theta = pos_mod_2pi(__fsub_rn(atan2f(vy, vx), angle));
      const float bf = __fmul_rn(theta, (float)(8.0 / 6.283185307179586));
      const float b0f = floorf(bf);
      frac[k] = __fsub_rn(bf, b0f);
      ori[k] = sfm_pos_mod((int)b0f, 8);
      contrib[k] =
          (inb && ok) ? __fmul_rn(magnitude(vx, vy), __ldg(tables + T_DESC_WG + t)) : 0.f;
      sum += warp_sum(contrib[k]);
    }
    SFM_ST(9)
    // The spatial weights are at most 1 each, so 16 x the contributions
    // bounds every bin.
    sh = sfm_fx_shift(16.0 * (double)sum);
    if (sh != SFM_FX_BAD) {
      const double scale = pow2(sh);
      const float* wax = tables + T_W_AXIS;  // (16 samples per axis, 4 bins)
      const int j = lane % 16;                // sample column (x): the lane's for every k
      const int bj = first_bin(wax, j);
      const float wx[2] = {__ldg(wax + j * 4 + bj), bj < 3 ? __ldg(wax + j * 4 + bj + 1) : 0.f};
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int i = 2 * k + lane / 16;      // sample row (y)
        const int bi = first_bin(wax, i);
        const float wy[2] = {__ldg(wax + i * 4 + bi),
                             bi < 3 ? __ldg(wax + i * 4 + bi + 1) : 0.f};
        const int o0 = ori[k], o1 = (o0 + 1) % 8;
        const float lo = __fsub_rn(1.f, frac[k]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (wy[u] == 0.f) continue;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if (wx[v] == 0.f) continue;
            const float base = __fmul_rn(__fmul_rn(wy[u], wx[v]), contrib[k]);
            unsigned int* cell = sm.fx_desc[0] + ((bi + u) * 4 + bj + v) * 8;
            fx_add(cell + o0, 128, __fmul_rn(base, lo), scale);
            fx_add(cell + o1, 128, __fmul_rn(base, frac[k]), scale);
          }
        }
      }
    }
  }
  __syncwarp();
  SFM_ST(5)
  // Normalise, clip, renormalise: lane l holds bins l + 32 q. Each norm is
  // the first design's block sum: the four groups' xor trees, then the
  // group sums in order from 0.f, the last four groups (bins past 128) zero.
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = fx_value(&sm.fx_desc[0][lane + 32 * q], 128, sh);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) s += warp_sum(__fmul_rn(v[q], v[q]));
#pragma unroll
  for (int q = 4; q < 8; ++q) s += 0.f;
  const float n1 = fmaxf(sqrtf(s), 1e-12f);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = fminf(__fdiv_rn(v[q], n1), clip);
  s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) s += warp_sum(__fmul_rn(v[q], v[q]));
#pragma unroll
  for (int q = 4; q < 8; ++q) s += 0.f;
  const float n2 = fmaxf(sqrtf(s), 1e-12f);
#pragma unroll
  for (int q = 0; q < 4; ++q) desc_out[(size_t)kp * 128 + lane + 32 * q] = __fdiv_rn(v[q], n2);
  if (lane == 0) angle_out[kp] = angle;
  SFM_ST(6)
  SFM_ST_END
}

}  // namespace

// Once, on the first launch: the largest shared-memory carveout, so that an
// SM holds as many warps' patches as its 227 KB take.
SFM_API int sfm_sift_describe_setup(void* /*stream*/) {
  const void* kernels[] = {(const void*)sift_describe_kernel<8>,
                           (const void*)sift_describe_kernel<2>,
                           (const void*)sift_describe_kernel<1>};
  for (const void* f : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

SFM_API int sfm_sift_describe(const void* canvas, int B, int S, int sumH,
                              int Wmax, const void* grad_layer, const void* x,
                              const void* y, const void* sigma_rel,
                              const void* row_off, const void* w_o,
                              const void* h_o, int K, const void* tables,
                              float descriptor_scale, float clip, void* angle,
                              void* desc, void* stream) {
  const int n = B * K;
  if (n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uintptr_t base = reinterpret_cast<uintptr_t>(canvas);
    const int E = (Wmax % 8 == 0 && base % 16 == 0) ? 8 : (Wmax % 2 == 0 && base % 4 == 0) ? 2 : 1;
    auto kernel = E == 8 ? sift_describe_kernel<8> : E == 2 ? sift_describe_kernel<2>
                                                            : sift_describe_kernel<1>;
    kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        static_cast<const __half*>(canvas), S, sumH, Wmax,
        static_cast<const int*>(grad_layer), static_cast<const float*>(x),
        static_cast<const float*>(y), static_cast<const float*>(sigma_rel),
        static_cast<const int*>(row_off), static_cast<const int*>(w_o),
        static_cast<const int*>(h_o), K, n, static_cast<const float*>(tables),
        descriptor_scale, clip, static_cast<float*>(angle), static_cast<float*>(desc));
  }
  return static_cast<int>(cudaGetLastError());
}
