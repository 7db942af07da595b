// Kernel K4, the rest of it: candidate selection and subpixel refinement (two entries).
//
// Replaces sfm_tpu/features/detect.py::select_octave_candidates (:121: the
// exact hierarchical top-budget -- 2x2 cell max, 4x4 block max, lax.top_k over
// the blocks, lax.top_k over the surviving blocks' cells, the winning pixel of
// each cell) and ::refine_and_gate (:230: the clamped 3x3x3 gather, the closed
// form offset, the convergence, contrast and edge gates), plus the frontend's
// "padding stays invalid" mask. XLA ran the selection as reduce-windows and
// two full sorts over up to 590k block maxima per image.
//
// sfm_dog_select launches five kernels:
//  1. one thread per 4x4 block: its max (the two max-pools at once; a window
//     that runs over the image edge also takes the max-pools' zero padding);
//  2. top-k1 of each image's block maxima (topk_rows_kernel, below);
//  3. one thread per (selected block, cell): the 2x2 cell max, -1 outside;
//  4. top-k2 of those 4 k1 cells (topk_rows_kernel);
//  5. one thread per output slot: the cell's winning pixel (the first of its
//     four whose score equals the cell max), clamped, padding past k2.
// sfm_topk_rows exposes step 2 alone: estimators/ransac.py::top_k on a CUDA
// tensor (the frontend's global keypoint selection, the sweep's match
// compaction). topk_rows_kernel is lax.top_k's order exactly: largest first, ties to the
// lower index. One block per row: a 4-pass radix select (8 bits a pass) on
// the float bits mapped to an unsigned order finds the k-th largest key; one
// ordered pass keeps every key above it and, of the keys equal to it, the
// lowest-indexed ones (a block-wide scan ranks the ties in index order); a
// bitonic sort of the k survivors in shared memory on (key desc, index asc).
//
// sfm_dog_refine: one thread per candidate. Every product and sum is rounded
// as the plain twin rounds it (__fmul_rn / __fadd_rn, no FMA contraction), in
// the twin's order, so the offsets and the 0.6 convergence and contrast gates
// are bit-identical.
//
// What bounds it on the H100: device memory. The selection reads each score
// once for the block maxima (37.7 MB for 12 images of the 1536 x 2048 octave
// with S = 3: ~11 us at 3.35 TB/s), then the block maxima five times
// (radix passes + compaction), one block per image: 12 of the 132 SMs stream
// the 2.4 MB rows, so the rows' passes, not the card's rate, set the time.
// The refinement reads 27 floats a candidate.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int TK_NT = 1024;

// Float -> unsigned with the same order (-0 taken as +0).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Max of the pixels [y0, y0 + n) x [x0, x0 + n) of a (h, w) plane; a window
// over the edge also takes 0 (the max-pools' zero padding).
__device__ __forceinline__ float window_max(const float* plane, int h, int w, int y0, int x0,
                                            int n) {
  float m = -INFINITY;
  bool clipped = false;
  for (int dy = 0; dy < n; ++dy)
    for (int dx = 0; dx < n; ++dx) {
      const int y = y0 + dy, x = x0 + dx;
      if (y < h && x < w)
        m = fmaxf(m, plane[(size_t)y * w + x]);
      else
        clipped = true;
    }
  return clipped ? fmaxf(m, 0.f) : m;
}

__global__ void __launch_bounds__(NT) block_max_kernel(const float* __restrict__ score,
                                                       int BS, int h, int w, int h4, int w4,
                                                       float* __restrict__ blk) {
  const size_t t = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t per = (size_t)h4 * w4;
  if (t >= (size_t)BS * per) return;
  const size_t bs = t / per;
  const int r = (int)(t % per);
  blk[t] = window_max(score + bs * h * w, h, w, 4 * (r / w4), 4 * (r % w4), 4);
}

// lax.top_k of each row of x (rows of n): vals / idx (rows of k), k <= kpad,
// kpad a power of two; kpad composite keys in dynamic shared memory.
__global__ void __launch_bounds__(TK_NT) topk_rows_kernel(const float* __restrict__ x, int n,
                                                          int k, int kpad,
                                                          float* __restrict__ vals,
                                                          int* __restrict__ idx) {
  extern __shared__ unsigned long long s_sel[];
  __shared__ int hist[256];
  __shared__ int s_warp[TK_NT / 32];
  __shared__ uint32_t s_prefix;
  __shared__ int s_need, s_eq_total, s_count, s_eq_base;
  const float* row = x + (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    s_prefix = 0u;
    s_need = k;
  }
  // Radix select: after the 4 passes s_prefix is the k-th largest key and
  // s_need the number of keys equal to it that belong to the top k.
  uint32_t mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += TK_NT) hist[d] = 0;
    __syncthreads();
    const uint32_t prefix = s_prefix;
    for (int i = tid; i < n; i += TK_NT) {
      const uint32_t u = order_key(row[i]);
      if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int cum = 0, d = 255;
      for (; d > 0; --d) {
        if (cum + hist[d] >= s_need) break;
        cum += hist[d];
      }
      s_need -= cum;
      s_prefix = prefix | ((uint32_t)d << shift);
      s_eq_total = hist[d];
      s_count = 0;
      s_eq_base = 0;
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  const uint32_t T = s_prefix;
  const int need_eq = s_need;
  const bool all_eq = s_eq_total == need_eq;

  // Compaction in index order: the ties are ranked by a block-wide scan.
  for (int base = 0; base < n; base += TK_NT) {
    const int i = base + tid;
    const uint32_t u = i < n ? order_key(row[i]) : 0u;
    const bool gt = i < n && u > T, eq = i < n && u == T;
    bool take = gt || (eq && all_eq);
    if (!all_eq) {
      const unsigned bal = __ballot_sync(0xffffffffu, eq);
      if (lane == 0) s_warp[warp] = __popc(bal);
      __syncthreads();
      int before = s_eq_base, total = 0;
      for (int k2 = 0; k2 < TK_NT / 32; ++k2) {
        before += k2 < warp ? s_warp[k2] : 0;
        total += s_warp[k2];
      }
      take = gt || (eq && before + __popc(bal & ((1u << lane) - 1u)) < need_eq);
      __syncthreads();
      if (tid == 0) s_eq_base += total;
    }
    if (take) {
      const int slot = atomicAdd(&s_count, 1);
      s_sel[slot] = ((unsigned long long)u << 32) | (0xffffffffu - (uint32_t)i);
    }
  }
  __syncthreads();
  for (int i = k + tid; i < kpad; i += TK_NT) s_sel[i] = 0ull;  // sorts last
  __syncthreads();

  // Bitonic sort, descending on (key, -index).
  for (int size = 2; size <= kpad; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kpad / 2; i += TK_NT) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = s_sel[lo], b = s_sel[hi];
        if ((a < b) == ((lo & size) == 0)) {
          s_sel[lo] = b;
          s_sel[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int i = tid; i < k; i += TK_NT) {
    const unsigned long long c = s_sel[i];
    vals[(size_t)blockIdx.x * k + i] = key_value((uint32_t)(c >> 32));
    idx[(size_t)blockIdx.x * k + i] = (int)(0xffffffffu - (uint32_t)c);
  }
}

struct Grid {
  int S, h, w, h2, w2, h4, w4;
  __device__ void block(int blk, int* l, int* by, int* bx) const {
    *l = blk / (h4 * w4);
    const int r = blk % (h4 * w4);
    *by = r / w4;
    *bx = r % w4;
  }
};

__global__ void __launch_bounds__(NT) cell_gather_kernel(const float* __restrict__ score,
                                                         Grid g, int total, int k1,
                                                         const int* __restrict__ bidx,
                                                         float* __restrict__ cs) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= total) return;
  const int q = t % 4, bi = t / 4, b = bi / k1;
  int l, by, bx;
  g.block(bidx[bi], &l, &by, &bx);
  const int cy = 2 * by + q / 2, cx = 2 * bx + q % 2;
  cs[t] = (cy < g.h2 && cx < g.w2)
              ? window_max(score + ((size_t)b * g.S + l) * g.h * g.w, g.h, g.w, 2 * cy, 2 * cx, 2)
              : -1.f;
}

__global__ void __launch_bounds__(NT) select_final_kernel(
    const float* __restrict__ score, Grid g, int B, int k1, int k2, int budget,
    const int* __restrict__ bidx, const int* __restrict__ cpos, const float* __restrict__ ctop,
    int64_t* __restrict__ layer_out, int64_t* __restrict__ y_out, int64_t* __restrict__ x_out,
    float* __restrict__ top_out) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= B * budget) return;
  const int b = t / budget, i = t % budget;
  int64_t layer = 1, y = 0, x = 0;
  float top = 0.f;
  if (i < k2) {
    const int c = cpos[b * k2 + i], sub = c % 4;
    int l, by, bx;
    g.block(bidx[b * k1 + c / 4], &l, &by, &bx);
    const int cell_y = 2 * by + sub / 2, cell_x = 2 * bx + sub % 2;
    const float ct = ctop[b * k2 + i];
    const float* plane = score + ((size_t)b * g.S + l) * g.h * g.w;
    int arg = 0;
    for (int q = 0; q < 4; ++q) {
      const int py = 2 * cell_y + q / 2, px = 2 * cell_x + q % 2;
      const float ps = (py < g.h && px < g.w) ? plane[(size_t)py * g.w + px] : -1.f;
      if (ps == ct) {
        arg = q;
        break;
      }
    }
    layer = l + 1;
    y = min(2 * cell_y + arg / 2, g.h - 1);
    x = min(2 * cell_x + arg % 2, g.w - 1);
    top = fmaxf(ct, 0.f);
  }
  layer_out[t] = layer;
  y_out[t] = y;
  x_out[t] = x;
  top_out[t] = top;
}

cudaError_t launch_topk(const float* x, int rows, int n, int k, float* vals, int* idx,
                        cudaStream_t st) {
  int kpad = 1;
  while (kpad < k) kpad <<= 1;
  const int smem = kpad * (int)sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(topk_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  topk_rows_kernel<<<rows, TK_NT, smem, st>>>(x, n, k, kpad, vals, idx);
  return cudaGetLastError();
}

// dog_refine's arithmetic, rounded after every operation.
__device__ __forceinline__ float ad(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sb(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float ml(float a, float b) { return __fmul_rn(a, b); }

__global__ void __launch_bounds__(NT) dog_refine_kernel(
    const float* __restrict__ dog, int BK, int K, int Sp2, int h, int w,
    const int64_t* __restrict__ layer, const int64_t* __restrict__ ys,
    const int64_t* __restrict__ xs, const float* __restrict__ cand, float contrast, float r,
    float r1sq, float* __restrict__ off_x, float* __restrict__ off_y, float* __restrict__ off_s,
    float* __restrict__ gated) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= BK) return;
  const int b = t / K;
  const float* D = dog + (size_t)b * Sp2 * h * w;
  int li[3], yi[3], xi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    li[d] = (int)sfm_clamp_index(layer[t] + d - 1, Sp2 - 1);
    yi[d] = (int)sfm_clamp_index(ys[t] + d - 1, h - 1);
    xi[d] = (int)sfm_clamp_index(xs[t] + d - 1, w - 1);
  }
  auto C = [&](int s, int y, int x) {
    return D[((size_t)li[s] * h + yi[y]) * w + xi[x]];
  };
  const float c = C(1, 1, 1);
  const float gx = ml(0.5f, sb(C(1, 1, 2), C(1, 1, 0)));
  const float gy = ml(0.5f, sb(C(1, 2, 1), C(1, 0, 1)));
  const float gs = ml(0.5f, sb(C(2, 1, 1), C(0, 1, 1)));
  const float c2 = ml(2.f, c);
  const float dxx = sb(ad(C(1, 1, 2), C(1, 1, 0)), c2);
  const float dyy = sb(ad(C(1, 2, 1), C(1, 0, 1)), c2);
  const float dss = sb(ad(C(2, 1, 1), C(0, 1, 1)), c2);
  const float dxy = ml(0.25f, sb(sb(ad(C(1, 2, 2), C(1, 0, 0)), C(1, 0, 2)), C(1, 2, 0)));
  const float dxs = ml(0.25f, ad(sb(sb(C(2, 1, 2), C(2, 1, 0)), C(0, 1, 2)), C(0, 1, 0)));
  const float dys = ml(0.25f, ad(sb(sb(C(2, 2, 1), C(2, 0, 1)), C(0, 2, 1)), C(0, 0, 1)));
  const float det = ad(sb(ml(dxx, sb(ml(dyy, dss), ml(dys, dys))),
                          ml(dxy, sb(ml(dxy, dss), ml(dys, dxs)))),
                       ml(dxs, sb(ml(dxy, dys), ml(dyy, dxs))));
  const float inv_det = fabsf(det) < 1e-12f ? 0.f : __fdiv_rn(1.f, det);
  const float a00 = sb(ml(dyy, dss), ml(dys, dys));
  const float a01 = sb(ml(dxs, dys), ml(dxy, dss));
  const float a02 = sb(ml(dxy, dys), ml(dxs, dyy));
  const float a11 = sb(ml(dxx, dss), ml(dxs, dxs));
  const float a12 = sb(ml(dxy, dxs), ml(dxx, dys));
  const float a22 = sb(ml(dxx, dyy), ml(dxy, dxy));
  const float ox = ml(-ad(ad(ml(a00, gx), ml(a01, gy)), ml(a02, gs)), inv_det);
  const float oy = ml(-ad(ad(ml(a01, gx), ml(a11, gy)), ml(a12, gs)), inv_det);
  const float os = ml(-ad(ad(ml(a02, gx), ml(a12, gy)), ml(a22, gs)), inv_det);
  const float refined = ad(c, ml(0.5f, ad(ad(ml(gx, ox), ml(gy, oy)), ml(gs, os))));
  const bool converged = fabsf(ox) < 0.6f && fabsf(oy) < 0.6f && fabsf(os) < 0.6f;
  const bool contrast_ok = fabsf(refined) >= contrast;
  const float tr = ad(dxx, dyy);
  const float det2 = sb(ml(dxx, dyy), ml(dxy, dxy));
  const bool edge_ok = det2 > 0.f && ml(ml(tr, tr), r) < ml(r1sq, det2);
  const bool keep = converged && contrast_ok && edge_ok && cand[t] > 0.f;
  off_x[t] = ox;
  off_y[t] = oy;
  off_s[t] = os;
  gated[t] = keep ? fabsf(refined) : 0.f;
}

}  // namespace

SFM_API int sfm_dog_select(const void* score, int B, int S, int h, int w, int budget, void* blk,
                           void* bidx, void* bval, void* cs, void* cpos, void* ctop, void* layer,
                           void* y, void* x, void* top, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Grid g{S, h, w, (h + 1) / 2, (w + 1) / 2, 0, 0};
  g.h4 = (g.h2 + 1) / 2;
  g.w4 = (g.w2 + 1) / 2;
  const int n1 = S * g.h4 * g.w4;
  const int k1 = min(budget, n1), k2 = min(budget, 4 * k1);
  if (B == 0 || budget == 0) return static_cast<int>(cudaGetLastError());
  const size_t nblk = (size_t)B * n1;
  block_max_kernel<<<(unsigned)((nblk + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const float*>(score), B * S, h, w, g.h4, g.w4, static_cast<float*>(blk));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_topk(static_cast<const float*>(blk), B, n1, k1, static_cast<float*>(bval),
                  static_cast<int*>(bidx), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ncell = B * k1 * 4;
  cell_gather_kernel<<<(ncell + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(score), g, ncell, k1, static_cast<const int*>(bidx),
      static_cast<float*>(cs));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_topk(static_cast<const float*>(cs), B, 4 * k1, k2, static_cast<float*>(ctop),
                  static_cast<int*>(cpos), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  select_final_kernel<<<(B * budget + NT - 1) / NT, NT, 0, st>>>(
      static_cast<const float*>(score), g, B, k1, k2, budget, static_cast<const int*>(bidx),
      static_cast<const int*>(cpos), static_cast<const float*>(ctop),
      static_cast<int64_t*>(layer), static_cast<int64_t*>(y), static_cast<int64_t*>(x),
      static_cast<float*>(top));
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_dog_refine(const void* dog, int B, int Sp2, int h, int w, const void* layer,
                           const void* y, const void* x, const void* cand, int K, float contrast,
                           float r, float r1sq, void* off_x, void* off_y, void* off_s,
                           void* gated, void* stream) {
  const int BK = B * K;
  if (BK > 0) {
    dog_refine_kernel<<<(BK + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dog), BK, K, Sp2, h, w, static_cast<const int64_t*>(layer),
        static_cast<const int64_t*>(y), static_cast<const int64_t*>(x),
        static_cast<const float*>(cand), contrast, r, r1sq, static_cast<float*>(off_x),
        static_cast<float*>(off_y), static_cast<float*>(off_s), static_cast<float*>(gated));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_topk_rows(const void* x, int rows, int n, int k, void* vals, void* idx,
                          void* stream) {
  if (rows == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (k > n) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_topk(static_cast<const float*>(x), rows, n, k,
                                      static_cast<float*>(vals), static_cast<int*>(idx),
                                      static_cast<cudaStream_t>(stream)));
}
