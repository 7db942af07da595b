// Kernel K4, the rest of it: candidate selection and subpixel refinement (two entries).
//
// Replaces sfm_tpu/features/detect.py::select_octave_candidates (:230: the
// exact hierarchical top-budget -- 2x2 cell max, 4x4 block max, lax.top_k over
// the blocks, lax.top_k over the surviving blocks' cells, the winning pixel of
// each cell) and ::refine_and_gate (:121: the clamped 3x3x3 gather, the closed
// form offset, the convergence, contrast and edge gates), plus the frontend's
// "padding stays invalid" mask. XLA ran the selection as reduce-windows and
// two full sorts over up to 590k block maxima per image.
//
// sfm_dog_select keeps lax.top_k's order at both levels: largest first (in
// IEEE total order, on the float bits mapped to an unsigned order key), ties
// to the lower index. The top-k1 of each image's block maxima runs over the
// whole card, for all images at once:
//  1. select_pass_kernel<true>, a CUDA block on each 4,096 block maxima of
//     each image: each 4x4 block's max (the two max-pools at once; a window
//     over the image edge also takes the max-pools' zero padding) as an
//     order key, written out, and the histogram of its top 8 bits with each
//     bin's largest and smallest key; a warp's equal digits add at once
//     (__match_any_sync, among the lanes that count: it is slow on many
//     distinct values), each block's bins into its image's. The last block of
//     the image (a ticket) chooses the digit of the k1-th largest key.
//  2. select_pass_kernel<false>, the same over the keys: the next 8 bits,
//     while it gathers the keys under the first digit (the candidates); then
//     select_cand_kernel, a block an image, the last two digits from the
//     candidates alone. An image stops once the keys under the digits are
//     all needed or all one key (a bin whose largest and smallest key agree:
//     the k1-th key is then known whole), so a grid whose positives are fewer
//     than the budget stops after pass 0 with the key of 0.
//  3. the compaction (select_count_kernel, select_write_kernel): every key
//     above the k1-th and, of those equal to it, the lowest-indexed needed
//     (each block's count, then the earlier blocks' and one block scan rank
//     them; skipped when all are needed), k1 of them, in slots a warp takes
//     at once;
//  4. rank_sort_kernel, four threads a survivor over the whole card: each
//     survivor's place in lax.top_k's order is the number of survivors above
//     it (one compare of packed (key, index) words);
//  5. one thread per (selected block, cell): the 2x2 cell max, -1 outside;
//     the top-k2 of those 4 k1 cells, a shared-memory row, by
//     topk_block_kernel;
//  6. one thread per output slot: the cell's winning pixel (the first of its
//     four whose score equals the cell max), clamped, padding past k2.
// (Rows too long for shared memory take topk_rows_kernel: one block a row, a
// 4-pass radix select, a block-scan compaction and a bitonic sort.)
//
// sfm_topk_rows: lax.top_k along the rows of a float32 (R, n) tensor,
// values and int64 indices, for estimators/ransac.py::top_k on a CUDA
// tensor (the frontend's global keypoint selection, 12 x 3,840 -> 2,048; the
// sweep's match compaction, 32 x 2,048 -> 1,024; the ORB merge, a full
// sort of 12 x 3,800; RANSAC's sampling without replacement, many rows,
// k <= 8). It replaces the lax.top_k calls of sfm_tpu/features/frontend.py,
// matching/core.py and features/binary.py. Three routes:
//  - k <= 32: a warp a row (topk_warp_kernel). Each lane keeps the k
//    largest (key, index) pairs of its strided share of the row in
//    registers; the warp then takes the largest head k times (shuffles).
//  - else, when the row and the sort buffers fit in shared memory: a block a
//    row (topk_block_kernel). The row is read once into shared memory as
//    order keys; the radix select's histograms add one atomic per digit a
//    warp (__match_any_sync) and one warp scans them by shuffles; the
//    compaction ranks each thread's contiguous share with one block scan, so
//    the survivors land in index order; a stable LSD radix sort on the key
//    alone (8-bit digits, each warp ranking its contiguous share 32 keys a
//    round by __match_any_sync; digits that no key varies in skipped)
//    orders them, the lower index first among ties.
//  - else topk_rows_kernel, which reads the row from global memory in each
//    pass.
// The wrapper's host work is a large part of a call at these sizes: the
// shared-memory limit is set once (sfm_topk_setup) and the kernel writes
// the int64 indices itself.
//
// sfm_dog_refine: one thread per candidate. Every product and sum is rounded
// as the plain twin rounds it (__fmul_rn / __fadd_rn, no FMA contraction), in
// the twin's order, so the offsets and the 0.6 convergence and contrast gates
// are bit-identical.
//
// What bounds it on the H100: device memory. The selection must read each
// score once for the block maxima: 453 MB for 12 images of the 1536 x 2048
// octave with S = 3 (37.7 MB an image), ~0.14 ms at 3.35 TB/s. The first pass
// streams them over every SM; the keys it writes (1/16 of that: 28 MB) are
// read again by pass 1 and the compaction (twice where ties are ranked), and
// the sorts see only k1 and 4 k1 values an image. The refinement reads 27
// floats a candidate.
// topk_rows must read each row once and write k values and indices (12 x
// 3,840 floats: 0.18 MB, ~0.06 us); with a block a row on 12-32 rows its time
// is the latency of one block's passes, and with a warp a row on 16k rows the
// read.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 256;
constexpr int TK_NT = 1024;

// Float -> unsigned in IEEE total order, as lax.top_k orders: +0.0 above
// -0.0, a NaN above +inf (below -inf with its sign bit set).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// One warp's keys into a radix pass's histogram: each key under the chosen
// digits (`in`) adds its digit, a warp's equal digits at once
// (__match_any_sync, which is slow on many distinct values, among those
// lanes only); with hi / lo, each bin's largest key and largest ~key too.
// Every lane of the warp calls it.
__device__ __forceinline__ void hist_keys(int* hist, uint32_t* hi, uint32_t* lo, bool in,
                                          uint32_t u, int shift) {
  const unsigned act = __ballot_sync(0xffffffffu, in);
  if (in) {
    const uint32_t d = (u >> shift) & 255u;
    const unsigned peers = __match_any_sync(act, d);
    uint32_t h = 0u, l = 0u;
    if (hi) {
      h = __reduce_max_sync(peers, u);
      l = __reduce_max_sync(peers, ~u);
    }
    if (threadIdx.x % 32 == __ffs(peers) - 1) {
      atomicAdd(&hist[d], __popc(peers));
      if (hi) {
        atomicMax(&hi[d], h);
        atomicMax(&lo[d], l);
      }
    }
  }
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

// lax.top_k of each row of x (rows of n): vals / idx (rows of k), k <= kpad,
// kpad a power of two; kpad composite keys in dynamic shared memory.
__global__ void __launch_bounds__(TK_NT) topk_rows_kernel(const float* __restrict__ x, int n,
                                                          int k, int kpad,
                                                          float* __restrict__ vals,
                                                          int64_t* __restrict__ idx) {
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
    idx[(size_t)blockIdx.x * k + i] = (int64_t)(0xffffffffu - (uint32_t)c);
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

// One thread per (selected block, cell): the 2x2 cell max, -1 outside.
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
    const int* __restrict__ bidx, const int64_t* __restrict__ cpos, const float* __restrict__ ctop,
    int64_t* __restrict__ layer_out, int64_t* __restrict__ y_out, int64_t* __restrict__ x_out,
    float* __restrict__ top_out) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= B * budget) return;
  const int b = t / budget, i = t % budget;
  int64_t layer = 1, y = 0, x = 0;
  float top = 0.f;
  if (i < k2) {
    const int c = (int)cpos[b * k2 + i], sub = c % 4;
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

cudaError_t launch_topk(const float* x, int rows, int n, int k, float* vals, int64_t* idx,
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

constexpr int TKW_NT = 256;   // topk_warp_kernel: a warp a row
constexpr int TKB_NT = 512;   // topk_block_kernel: a block a row
constexpr int TKB_W = TKB_NT / 32;

// (key desc, index asc) as one descending 64-bit word.
__device__ __forceinline__ unsigned long long topk_pack(uint32_t key, int i) {
  return ((unsigned long long)key << 32) | (0xffffffffu - (uint32_t)i);
}

// k <= KW: each lane keeps the KW largest packed pairs of its elements
// (lane, lane + 32, ...; with vec4, the float4s lane, lane + 32, ..., four
// in flight) sorted in registers, then the warp takes the largest head k
// times. 0 sorts below every pair.
template <int KW>
__global__ void __launch_bounds__(TKW_NT) topk_warp_kernel(const float* __restrict__ x,
                                                           int rows, int n, int k,
                                                           float* __restrict__ vals,
                                                           int64_t* __restrict__ idx,
                                                           bool vec4) {
  const int row = blockIdx.x * (TKW_NT / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const float* xr = x + (size_t)row * n;
  unsigned long long top[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) top[j] = 0ull;
  auto insert = [&](float v, int i) {
    const unsigned long long p = topk_pack(order_key(v), i);
    if (p > top[KW - 1]) {
#pragma unroll
      for (int j = KW - 1; j > 0; --j) top[j] = p > top[j - 1] ? top[j - 1] : (p > top[j] ? p : top[j]);
      top[0] = p > top[0] ? p : top[0];
    }
  };
  if (vec4) {  // four float4 a lane in flight at once
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const int n4 = n / 4;
    for (int b = lane; b < n4; b += 128) {
      float4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        q[u] = b + 32 * u < n4 ? x4[b + 32 * u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (b + 32 * u >= n4) break;
        const int i = 4 * (b + 32 * u);
        insert(q[u].x, i);
        insert(q[u].y, i + 1);
        insert(q[u].z, i + 2);
        insert(q[u].w, i + 3);
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) insert(xr[i], i);
  }
  for (int r = 0; r < k; ++r) {
    unsigned long long best = top[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (top[0] == best) {  // pairs are distinct: one lane
#pragma unroll
      for (int j = 0; j < KW - 1; ++j) top[j] = top[j + 1];
      top[KW - 1] = 0ull;
    }
    if (lane == 0) {
      vals[(size_t)row * k + r] = key_value((uint32_t)(best >> 32));
      idx[(size_t)row * k + r] = (int64_t)(0xffffffffu - (uint32_t)best);
    }
  }
}

// Exclusive block scan (in thread order) of M 64-bit counts a thread.
// Every thread of the block calls it.
template <int M>
__device__ __forceinline__ void topk_scan(unsigned long long (&c)[M],
                                          unsigned long long (*s_w)[M]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  unsigned long long inc[M];
#pragma unroll
  for (int q = 0; q < M; ++q) inc[q] = c[q];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, inc[q], off);
      if (lane >= off) inc[q] += y;
    }
  if (lane == 31)
#pragma unroll
    for (int q = 0; q < M; ++q) s_w[w][q] = inc[q];
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int q = 0; q < M; ++q) {
      unsigned long long v = lane < TKB_W ? s_w[lane][q] : 0ull, sc = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xffffffffu, sc, off);
        if (lane >= off) sc += y;
      }
      if (lane < TKB_W) s_w[lane][q] = sc - v;   // the warps before
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < M; ++q) c[q] = inc[q] - c[q] + s_w[w][q];
}

// A block a row, the row staged in shared memory as order keys. Dynamic
// shared memory: n keys, then two buffers of k keys and two of k indices.
// CALLER: 0 for sfm_topk_rows, 1 for sfm_dog_select (the same code under two
// names, so that a trace tells the callers apart).
template <int CALLER>
__global__ void __launch_bounds__(TKB_NT) topk_block_kernel(const float* __restrict__ x, int n,
                                                            int k, float* __restrict__ vals,
                                                            int64_t* __restrict__ idx) {
  extern __shared__ uint32_t s_dyn32[];
  uint32_t* s_row = s_dyn32;
  uint32_t* s_key[2] = {s_row + n, s_row + n + k};
  int* s_idx[2] = {reinterpret_cast<int*>(s_row + n + 2 * k),
                   reinterpret_cast<int*>(s_row + n + 3 * k)};
  __shared__ int hist[256];
  __shared__ unsigned long long s_w[TKB_W][2];
  __shared__ uint32_t s_prefix, s_or, s_and;
  __shared__ int s_need;
  const int tid = threadIdx.x, lane = tid % 32;
  const float* row = x + (size_t)blockIdx.x * n;
  const bool all = k == n;  // a full sort: every key survives
  if (tid < 256) hist[tid] = 0;
  if (tid == 0) {
    s_prefix = 0u;
    s_need = k;
    s_or = 0u;
    s_and = 0xffffffffu;
  }
  __syncthreads();
  // Radix select, 8 bits a pass (the first one while staging the row): after
  // the passes s_prefix is the k-th largest key and s_need the number of
  // keys equal to it that belong to the top k.
  uint32_t mask = 0u;
  for (int shift = 24; shift >= 0 && !all; shift -= 8) {
    const uint32_t prefix = s_prefix;
    for (int base = 0; base < n; base += TKB_NT) {
      const int i = base + tid;
      uint32_t u = 0u;
      if (i < n) {
        if (shift == 24) {
          u = order_key(row[i]);
          s_row[i] = u;
        } else {
          u = s_row[i];
        }
      }
      hist_keys(hist, nullptr, nullptr, i < n && (u & mask) == prefix, u, shift);
    }
    __syncthreads();
    if (tid < 32) {  // the bins from the top, eight a lane; the first reaching s_need
      const int need = s_need;
      int cnt[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
      const int L = __ffs(hit) - 1;  // need <= the keys left, so some lane hits
      if (lane == L) {
        int cum = incl - sum, j = 0;
        for (; j < 7; ++j) {
          if (cum + cnt[j] >= need) break;
          cum += cnt[j];
        }
        const int d = 255 - 8 * lane - j;
        s_need = need - cum;
        s_prefix = prefix | ((uint32_t)d << shift);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) hist[255 - 8 * lane - j] = 0;  // the bins this lane read
    }
    mask |= 255u << shift;
    __syncthreads();
  }
  if (all) {
    for (int i = tid; i < n; i += TKB_NT) s_row[i] = order_key(row[i]);
    __syncthreads();
  }
  const uint32_t T = all ? 0u : s_prefix;
  const int need_eq = all ? n : s_need;
  // Compaction in index order: thread t takes the contiguous share
  // [t E, t E + E); one block scan ranks the keys above T and those equal.
  // (An odd share: the threads of a warp then read distinct banks.)
  const int E = ((n + TKB_NT - 1) / TKB_NT) | 1, i0 = min(tid * E, n), i1 = min(i0 + E, n);
  unsigned long long c[2] = {0ull, 0ull};
  for (int i = i0; i < i1; ++i) {
    const uint32_t u = s_row[i];
    c[0] += u > T || all ? 1ull : 0ull;
    c[1] += u == T && !all ? 1ull : 0ull;
  }
  topk_scan<2>(c, s_w);
  {
    unsigned long long gt = c[0], eq = c[1];
    for (int i = i0; i < i1; ++i) {
      const uint32_t u = s_row[i];
      const bool g = u > T || all, q = u == T && !all;
      if (g || (q && eq < (unsigned long long)need_eq)) {
        const int pos = (int)(gt + min(eq, (unsigned long long)need_eq));
        s_key[0][pos] = ~u;  // ascending on ~key: the largest first
        s_idx[0][pos] = i;
      }
      gt += g ? 1ull : 0ull;
      eq += q ? 1ull : 0ull;
    }
  }
  // The digits some survivor varies in.
  __syncthreads();
  {
    uint32_t o = 0u, a = 0xffffffffu;
    for (int i = tid; i < k; i += TKB_NT) {
      o |= s_key[0][i];
      a &= s_key[0][i];
    }
    o = __reduce_or_sync(0xffffffffu, o);
    a = __reduce_and_sync(0xffffffffu, a);
    if (lane == 0) {
      atomicOr(&s_or, o);
      atomicAnd(&s_and, a);
    }
  }
  __syncthreads();
  const uint32_t vary = s_or ^ s_and;
  int cur = 0;
  {
    // Stable LSD radix sort, 8 bits a pass; warp w ranks its contiguous
    // share in rounds of 32 (peers by __match_any_sync), so the survivors,
    // in index order, keep the lower index first among equal keys.
    __shared__ int s_wh[256][TKB_W + 1];
    __shared__ int s_dsum[8];
    const int w = tid / 32;
    const int WC = (k + TKB_W - 1) / TKB_W, c0 = min(w * WC, k), c1 = min(c0 + WC, k);
    for (int shift = 0; shift < 32; shift += 8) {
      if (((vary >> shift) & 255u) == 0u) continue;  // the same for the block
      const uint32_t* ks = s_key[cur];
      const int* is = s_idx[cur];
      for (int i = tid; i < 256 * (TKB_W + 1); i += TKB_NT) (&s_wh[0][0])[i] = 0;
      __syncthreads();
      for (int b = c0; b < c1; b += 32) {
        const int j = b + lane;
        const uint32_t d = j < c1 ? (ks[j] >> shift) & 255u : 256u + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (j < c1 && lane == 31 - __clz(peers)) s_wh[d][w] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      int tot = 0;
      if (tid < 256) {
        for (int ww = 0; ww < TKB_W; ++ww) {
          const int v = s_wh[tid][ww];
          s_wh[tid][ww] = tot;
          tot += v;
        }
      }
      int incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (tid < 256 && lane == 31) s_dsum[tid / 32] = incl;
      __syncthreads();
      if (tid < 256) {
        int base = incl - tot;
        for (int q = 0; q < tid / 32; ++q) base += s_dsum[q];
        for (int ww = 0; ww < TKB_W; ++ww) s_wh[tid][ww] += base;
      }
      __syncthreads();
      uint32_t* kd = s_key[cur ^ 1];
      int* id = s_idx[cur ^ 1];
      for (int b = c0; b < c1; b += 32) {
        const int j = b + lane;
        const bool in = j < c1;
        const uint32_t key = in ? ks[j] : 0u;
        const uint32_t d = in ? (key >> shift) & 255u : 256u + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int pos = in ? s_wh[d][w] + __popc(peers & ((1u << lane) - 1u)) : 0;
        __syncwarp();
        if (in && lane == 31 - __clz(peers)) s_wh[d][w] += __popc(peers);
        __syncwarp();
        if (in) {
          kd[pos] = key;
          id[pos] = is[j];
        }
      }
      cur ^= 1;
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += TKB_NT) {
    vals[(size_t)blockIdx.x * k + j] = key_value(~s_key[cur][j]);
    idx[(size_t)blockIdx.x * k + j] = s_idx[cur][j];
  }
}

// Dynamic shared memory of topk_block_kernel.
__host__ __device__ constexpr size_t topk_block_smem(int n, int k) {
  return (size_t)4 * ((size_t)n + 4 * (size_t)k);
}

int g_topk_smem = 0;  // the opt-in limit set by sfm_topk_setup

// lax.top_k of rows of n, k of them: a block a row in shared memory where the
// row fits (topk_block_kernel), else the first design's kernel.
template <int CALLER>
cudaError_t topk_long(const float* x, int rows, int n, int k, float* vals, int64_t* idx,
                      cudaStream_t st) {
  if (topk_block_smem(n, k) <= (size_t)g_topk_smem) {
    topk_block_kernel<CALLER><<<rows, TKB_NT, topk_block_smem(n, k), st>>>(x, n, k, vals, idx);
    return cudaGetLastError();
  }
  return launch_topk(x, rows, n, k, vals, idx, st);
}

// ---- dog_select's top-k1 of each image's block maxima, over the whole card.
// An image's n1 keys are cut into blocks of SEL_KPB; every pass runs a CUDA
// block on each, for all images at once (blockIdx.y the image).
constexpr int SEL_NT = 256;                      // select_pass_kernel
constexpr int SEL_KPT = 16;                      // its keys a thread, SEL_NT apart
constexpr int SEL_KPB = SEL_NT * SEL_KPT;        // keys a block: 4,096
constexpr int SCAN_KPT = SEL_KPB / TKB_NT;       // the count and write passes' contiguous share
// An image's control words: for passes 0 and 1 (which many blocks share),
// the digit's histogram and each bin's largest key and largest complemented
// key (so its smallest key); then
// the selection's state: the k1-th largest key's digits chosen so far (PREFIX
// under MASK; the whole key once it is known), how many keys equal to it
// under the mask belong to the top k1 (NEED), ALL when that is every one of
// them, DONE when no further pass is needed, each pass's ticket, the
// survivors' slot counter and the candidates' count.
constexpr int PASS_WORDS = 3 * 256;
enum {
  ST_PREFIX = 2 * PASS_WORDS, ST_MASK, ST_NEED, ST_ALL, ST_DONE, ST_TICKET,
  ST_SLOT = ST_TICKET + 2, ST_NCAND, CTL
};

// The max of block i of image b (the two max-pools at once), as window_max
// computes it; a block wholly inside a plane whose rows are 16-byte aligned
// is read as four float4s.
__device__ __forceinline__ float block_max(const float* __restrict__ score, const Grid& g, int b,
                                           int i, bool vec) {
  int l, by, bx;
  g.block(i, &l, &by, &bx);
  const float* plane = score + ((size_t)b * g.S + l) * g.h * g.w;
  const int y0 = 4 * by, x0 = 4 * bx;
  if (vec && y0 + 4 <= g.h && x0 + 4 <= g.w) {
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const float4 q = *reinterpret_cast<const float4*>(plane + (size_t)(y0 + dy) * g.w + x0);
      m = fmaxf(m, q.x);
      m = fmaxf(m, q.y);
      m = fmaxf(m, q.z);
      m = fmaxf(m, q.w);
    }
    return m;
  }
  return window_max(plane, g.h, g.w, y0, x0, 4);
}

// Radix pass `pass` (8 bits a pass, from the top) over every image's keys: the
// histogram of the digit among the keys that match the digits chosen so far,
// with each bin's largest and smallest key (a warp's equal digits added at
// once: __match_any_sync among the lanes that count, then one shared atomic a
// group; each block's bins into its image's), then the last block of the
// image to finish (its ticket) chooses the digit of the k1-th largest key. A
// bin whose keys are all one key gives that key at once. Pass 0 makes the
// keys: each block maximum's order key; pass 1 gathers the keys under pass
// 0's digit, and the later passes read only those. An image whose selection
// is done skips the later passes.
// Warp 0 of a block: the digit (bits [shift, shift + 8)) of the k1-th largest
// key from a pass's histogram and each bin's largest key and largest ~key,
// need of it still to find under (prefix, mask); the state it leaves: the
// digit added to the prefix -- or the whole key, when the bin's keys are all
// one key -- how many keys equal to it are needed, and whether that is all
// of them or the last digit, so that no pass is left.
__device__ __forceinline__ void pick_digit(const int* hist, const uint32_t* hi,
                                           const uint32_t* lo, int need, uint32_t prefix,
                                           uint32_t mask, int shift, int* st) {
  const int lane = threadIdx.x % 32;
  int cnt[8], sum = 0;  // the bins from the top, eight a lane; the first reaching need
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[j] = hist[255 - 8 * lane - j];
    sum += cnt[j];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const unsigned hit = __ballot_sync(0xffffffffu, incl >= need);
  if (lane == __ffs(hit) - 1) {  // need <= the keys under the prefix, so some lane hits
    int cum = incl - sum, j = 0;
    for (; j < 7; ++j) {
      if (cum + cnt[j] >= need) break;
      cum += cnt[j];
    }
    const int d = 255 - 8 * lane - j;
    const uint32_t h = hi[d], l = ~lo[d];
    st[ST_NEED] = need - cum;
    st[ST_PREFIX] = (int)(h == l ? h : prefix | ((uint32_t)d << shift));
    st[ST_MASK] = (int)(h == l ? 0xffffffffu : mask | (255u << shift));
    st[ST_ALL] = cnt[j] == need - cum;
    st[ST_DONE] = h == l || cnt[j] == need - cum || shift == 0;
  }
}

// Pass 0 reads the scores and makes the keys; pass 1 reads the keys and
// gathers those under pass 0's digit: the candidates.
template <bool FIRST>
__global__ void __launch_bounds__(SEL_NT) select_pass_kernel(const float* __restrict__ score,
                                                             Grid g, int n1, int k1, bool vec,
                                                             uint32_t* __restrict__ keys,
                                                             uint32_t* __restrict__ cand,
                                                             int* __restrict__ ctl) {
  __shared__ int hist[256];
  __shared__ uint32_t s_hi[256], s_lo[256];  // each bin's largest key, largest ~key
  __shared__ bool s_last;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32;
  int* st = ctl + (size_t)b * CTL;
  if (!FIRST && st[ST_DONE]) return;
  const uint32_t prefix = FIRST ? 0u : (uint32_t)st[ST_PREFIX];
  const uint32_t mask = FIRST ? 0u : (uint32_t)st[ST_MASK];
  const int n = n1, pass = FIRST ? 0 : 1, shift = 24 - 8 * pass;
  hist[tid] = 0;
  s_hi[tid] = 0u;
  s_lo[tid] = 0u;
  __syncthreads();
  uint32_t* row = keys + (size_t)b * n1;
  // A block's SEL_KPB keys, in batches of KB a thread: their loads first, then
  // their digits.
  constexpr int KB = 8;
  const int base = blockIdx.x * SEL_KPB + tid;
  for (int j0 = 0; j0 < SEL_KPT; j0 += KB) {
    uint32_t uk[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int i = base + (j0 + j) * SEL_NT;
      uk[j] = i >= n ? 0u : FIRST ? order_key(block_max(score, g, b, i, vec)) : row[i];
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int i = base + (j0 + j) * SEL_NT;
      const uint32_t u = uk[j];
      if (FIRST && i < n) row[i] = u;
      const bool in = i < n && (u & mask) == prefix;
      if (!FIRST) {  // the candidates, a warp's at once
        const unsigned act = __ballot_sync(0xffffffffu, in);
        if (act != 0u) {
          int slot = 0;
          if (lane == 0) slot = atomicAdd(&st[ST_NCAND], __popc(act));
          slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(act & ((1u << lane) - 1u));
          if (in) cand[(size_t)b * n1 + slot] = u;
        }
      }
      hist_keys(hist, s_hi, s_lo, in, u, shift);
    }
  }
  __syncthreads();
  int* gh = st + PASS_WORDS * pass;
  unsigned* ghi = reinterpret_cast<unsigned*>(gh + 256);
  unsigned* glo = reinterpret_cast<unsigned*>(gh + 512);
  if (hist[tid] != 0) {
    atomicAdd(&gh[tid], hist[tid]);
    atomicMax(&ghi[tid], s_hi[tid]);
    atomicMax(&glo[tid], s_lo[tid]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&st[ST_TICKET + pass], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last || tid >= 32) return;
  __threadfence();
  for (int j = lane; j < 256; j += 32) {  // the image's bins, from L2
    hist[j] = __ldcg(&gh[j]);
    s_hi[j] = __ldcg(&ghi[j]);
    s_lo[j] = __ldcg(&glo[j]);
  }
  __syncwarp();
  pick_digit(hist, s_hi, s_lo, FIRST ? k1 : st[ST_NEED], prefix, mask, shift, st);
}

// Passes 2 and 3 over each image's candidates, a block an image (they are
// few): each pass's histogram, then its digit, as select_pass_kernel.
__global__ void __launch_bounds__(SEL_NT) select_cand_kernel(const uint32_t* __restrict__ cand,
                                                             int n1, int* __restrict__ ctl) {
  __shared__ int hist[256];
  __shared__ uint32_t s_hi[256], s_lo[256];
  const int b = blockIdx.x, tid = threadIdx.x;
  int* st = ctl + (size_t)b * CTL;
  const uint32_t* row = cand + (size_t)b * n1;
  for (int shift = 8; shift >= 0; shift -= 8) {
    __syncthreads();  // the state the last pick wrote (read from L2: L1 may hold the old)
    if (__ldcg(&st[ST_DONE])) return;
    const uint32_t prefix = (uint32_t)__ldcg(&st[ST_PREFIX]);
    const uint32_t mask = (uint32_t)__ldcg(&st[ST_MASK]);
    const int n = __ldcg(&st[ST_NCAND]), need = __ldcg(&st[ST_NEED]);
    hist[tid] = 0;
    s_hi[tid] = 0u;
    s_lo[tid] = 0u;
    __syncthreads();
    for (int base = 0; base < n; base += SEL_NT) {
      const int i = base + tid;
      const uint32_t u = i < n ? row[i] : 0u;
      hist_keys(hist, s_hi, s_lo, i < n && (u & mask) == prefix, u, shift);
    }
    __syncthreads();
    if (tid < 32) pick_digit(hist, s_hi, s_lo, need, prefix, mask, shift, st);
  }
}

// A block's SEL_KPB keys, staged in shared memory by coalesced loads; each
// thread's contiguous SCAN_KPT of them (index order across the threads).
__device__ __forceinline__ void staged_share(uint32_t* s_keys, const uint32_t* row, int n1,
                                             uint32_t (&u)[SCAN_KPT]) {
  const int blk0 = blockIdx.x * SEL_KPB;
  for (int j = threadIdx.x; j < SEL_KPB; j += TKB_NT)
    s_keys[j] = blk0 + j < n1 ? row[blk0 + j] : 0u;
  __syncthreads();
  const uint4* v = reinterpret_cast<const uint4*>(s_keys + threadIdx.x * SCAN_KPT);
#pragma unroll
  for (int q = 0; q < SCAN_KPT / 4; ++q) {
    const uint4 t = v[q];
    u[4 * q] = t.x;
    u[4 * q + 1] = t.y;
    u[4 * q + 2] = t.z;
    u[4 * q + 3] = t.w;
  }
}

// Each block's keys equal to the chosen prefix (under the mask), unless they
// are all taken.
__global__ void __launch_bounds__(TKB_NT) select_count_kernel(const uint32_t* __restrict__ keys,
                                                              int n1, const int* __restrict__ ctl,
                                                              int* __restrict__ cnt) {
  __shared__ __align__(16) uint32_t s_keys[SEL_KPB];
  __shared__ int red[TKB_W][1];
  const int b = blockIdx.y;
  const int* st = ctl + (size_t)b * CTL;
  if (st[ST_ALL]) return;
  const uint32_t T = (uint32_t)st[ST_PREFIX], M = (uint32_t)st[ST_MASK];
  uint32_t u[SCAN_KPT];
  staged_share(s_keys, keys + (size_t)b * n1, n1, u);
  const int i0 = blockIdx.x * SEL_KPB + threadIdx.x * SCAN_KPT;
  int c[1] = {0};
#pragma unroll
  for (int j = 0; j < SCAN_KPT; ++j) c[0] += i0 + j < n1 && (u[j] & M) == T ? 1 : 0;
  sfm_block_sum<TKB_NT, 1, int>(c, red);
  if (threadIdx.x == 0) cnt[(size_t)b * gridDim.x + blockIdx.x] = c[0];
}

// The compaction: every key above the prefix and, of those equal to it, the
// NEED lowest-indexed (the earlier blocks' counts, then one block scan, rank
// them in index order), as values and indices, k1 of them in slots a warp
// takes at once; their order is made by rank_sort_kernel.
__global__ void __launch_bounds__(TKB_NT) select_write_kernel(
    const uint32_t* __restrict__ keys, int n1, int k1, int* __restrict__ ctl,
    const int* __restrict__ cnt, float* __restrict__ sval, int* __restrict__ sidx) {
  __shared__ __align__(16) uint32_t s_keys[SEL_KPB];
  __shared__ int red[TKB_W][1];
  __shared__ unsigned long long s_w[TKB_W][1];
  const int b = blockIdx.y, lane = threadIdx.x % 32;
  int* st = ctl + (size_t)b * CTL;
  const uint32_t T = (uint32_t)st[ST_PREFIX], M = (uint32_t)st[ST_MASK];
  const unsigned long long need = (unsigned long long)st[ST_NEED];
  const bool all = st[ST_ALL];
  uint32_t u[SCAN_KPT];
  staged_share(s_keys, keys + (size_t)b * n1, n1, u);
  const int i0 = blockIdx.x * SEL_KPB + threadIdx.x * SCAN_KPT;
  unsigned long long c[1] = {0ull};
#pragma unroll
  for (int j = 0; j < SCAN_KPT; ++j) c[0] += i0 + j < n1 && (u[j] & M) == T ? 1ull : 0ull;
  unsigned long long eq = 0ull;  // the keys equal to the prefix before this thread's
  if (!all) {
    int before[1] = {0};
    for (int q = threadIdx.x; q < (int)blockIdx.x; q += TKB_NT)
      before[0] += cnt[(size_t)b * gridDim.x + q];
    sfm_block_sum<TKB_NT, 1, int>(before, red);
    topk_scan<1>(c, s_w);
    eq = c[0] + before[0];
  }
#pragma unroll
  for (int j = 0; j < SCAN_KPT; ++j) {
    const bool ok = i0 + j < n1;
    const uint32_t um = u[j] & M;
    const bool q = ok && um == T;
    const bool take = (ok && um > T) || (q && (all || eq < need));
    eq += q ? 1ull : 0ull;
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (bal == 0u) continue;
    int slot = 0;
    if (lane == 0) slot = atomicAdd(&st[ST_SLOT], __popc(bal));
    slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(bal & ((1u << lane) - 1u));
    if (take) {
      sval[(size_t)b * k1 + slot] = key_value(u[j]);
      sidx[(size_t)b * k1 + slot] = i0 + j;
    }
  }
}

constexpr int RS_NT = 256;      // rank_sort_kernel
constexpr int RS_Q = 4;         // its threads a survivor
constexpr int RS_CHUNK = 2048;  // its survivors staged in shared memory at a time

// The survivors of each image in lax.top_k's order, RS_Q threads a survivor:
// its place is the number of survivors above it -- the larger keys and, of
// the equal ones, those of lower index: one compare of the packed (key,
// index) words of topk_pack -- counted against the survivors staged in
// shared memory a chunk at a time, each thread a quarter of them, two a load.
// The places are a permutation; each gets its block's index.
__global__ void __launch_bounds__(RS_NT) rank_sort_kernel(const float* __restrict__ sval,
                                                          const int* __restrict__ sidx, int k1,
                                                          int* __restrict__ bidx) {
  __shared__ __align__(16) unsigned long long s_pack[RS_CHUNK];
  const int b = blockIdx.y, q = threadIdx.x % RS_Q;
  const int i = blockIdx.x * (RS_NT / RS_Q) + threadIdx.x / RS_Q;
  const float* row = sval + (size_t)b * k1;
  const int* irow = sidx + (size_t)b * k1;
  const bool ok = i < k1;
  const unsigned long long me = ok ? topk_pack(order_key(row[i]), irow[i]) : 0ull;
  int rank = 0;
  for (int c0 = 0; c0 < k1; c0 += RS_CHUNK) {
    const int n = min(RS_CHUNK, k1 - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < RS_CHUNK; j += RS_NT)  // past n: 0, below every survivor
      s_pack[j] = j < n ? topk_pack(order_key(row[c0 + j]), irow[c0 + j]) : 0ull;
    __syncthreads();
#pragma unroll 4
    for (int m = q; m < (n + 1) / 2; m += RS_Q) {
      const ulonglong2 v = reinterpret_cast<const ulonglong2*>(s_pack)[m];
      rank += (v.x > me ? 1 : 0) + (v.y > me ? 1 : 0);
    }
  }
#pragma unroll
  for (int off = 1; off < RS_Q; off <<= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
  if (ok && q == 0) bidx[(size_t)b * k1 + rank] = irow[i];
}

// sfm_dog_select's workspace in 32-bit words: the keys, the candidates, the
// control words, the block counts, the survivors' values and indices, the
// selected blocks in order, the cells and their top values; then (8-byte
// aligned) the top cells' positions, int64
// (features/detect.py::dog_select_plan).
size_t select_words(int B, int n1, int k1, int k2) {
  const size_t nblk = (n1 + SEL_KPB - 1) / SEL_KPB;
  size_t w = (size_t)B * (2 * (size_t)n1 + CTL + nblk + 7 * (size_t)k1 + k2);
  w += w & 1;
  return w + 2 * (size_t)B * k2;
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

// work: select_words(B, n1, k1, k2) 32-bit words (words: its size).
SFM_API int sfm_dog_select(const void* score, int B, int S, int h, int w, int budget, void* work,
                           long long words, void* layer, void* y, void* x, void* top,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Grid g{S, h, w, (h + 1) / 2, (w + 1) / 2, 0, 0};
  g.h4 = (g.h2 + 1) / 2;
  g.w4 = (g.w2 + 1) / 2;
  const int n1 = S * g.h4 * g.w4;
  const int k1 = min(budget, n1), k2 = min(budget, 4 * k1);
  if (B == 0 || budget == 0) return static_cast<int>(cudaGetLastError());
  if (words < 0 || (size_t)words < select_words(B, n1, k1, k2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (n1 + SEL_KPB - 1) / SEL_KPB;
  uint32_t* keys = static_cast<uint32_t*>(work);
  uint32_t* cand = keys + (size_t)B * n1;
  int* ctl = reinterpret_cast<int*>(cand + (size_t)B * n1);
  int* cnt = ctl + (size_t)B * CTL;
  float* sval = reinterpret_cast<float*>(cnt + (size_t)B * nblk);
  int* sidx = reinterpret_cast<int*>(sval + (size_t)B * k1);
  int* bidx = sidx + (size_t)B * k1;
  float* cs = reinterpret_cast<float*>(bidx + (size_t)B * k1);
  float* ctop = cs + 4 * (size_t)B * k1;
  uint32_t* tail = reinterpret_cast<uint32_t*>(ctop + (size_t)B * k2);
  tail += (tail - keys) & 1;
  int64_t* cpos = reinterpret_cast<int64_t*>(tail);
  const float* sc = static_cast<const float*>(score);
  cudaError_t e = cudaMemsetAsync(ctl, 0, sizeof(int) * (size_t)B * CTL, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(score) % 16 == 0;
  const dim3 grid(nblk, B);
  select_pass_kernel<true><<<grid, SEL_NT, 0, st>>>(sc, g, n1, k1, vec, keys, cand, ctl);
  select_pass_kernel<false><<<grid, SEL_NT, 0, st>>>(sc, g, n1, k1, vec, keys, cand, ctl);
  select_cand_kernel<<<B, SEL_NT, 0, st>>>(cand, n1, ctl);
  select_count_kernel<<<grid, TKB_NT, 0, st>>>(keys, n1, ctl, cnt);
  select_write_kernel<<<grid, TKB_NT, 0, st>>>(keys, n1, k1, ctl, cnt, sval, sidx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rank_sort_kernel<<<dim3((k1 + RS_NT / RS_Q - 1) / (RS_NT / RS_Q), B), RS_NT, 0, st>>>(
      sval, sidx, k1, bidx);
  const int ncell = B * k1 * 4;
  cell_gather_kernel<<<(ncell + NT - 1) / NT, NT, 0, st>>>(sc, g, ncell, k1, bidx, cs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = topk_long<1>(cs, B, 4 * k1, k2, ctop, cpos, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  select_final_kernel<<<(B * budget + NT - 1) / NT, NT, 0, st>>>(
      sc, g, B, k1, k2, budget, bidx, cpos, ctop, static_cast<int64_t*>(layer),
      static_cast<int64_t*>(y), static_cast<int64_t*>(x), static_cast<float*>(top));
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

// Once, on the first launch: topk_block_kernel may take the device's
// opt-in shared memory (227 KB on the H100).
SFM_API int sfm_topk_setup(void* /*stream*/) {
  int dev = 0, bytes = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, topk_block_kernel<0>);
  if (e == cudaSuccess) {
    g_topk_smem = bytes - (int)attr.sharedSizeBytes;
    e = cudaFuncSetAttribute(topk_block_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_topk_smem);
  }
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(topk_block_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_topk_smem);
  return static_cast<int>(e);
}

// vals (rows, k) float, idx (rows, k) int64.
SFM_API int sfm_topk_rows(const void* x, int rows, int n, int k, void* vals, void* idx,
                          void* stream) {
  if (rows == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (k > n) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* v = static_cast<float*>(vals);
  int64_t* id = static_cast<int64_t*>(idx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wblocks = (rows + TKW_NT / 32 - 1) / (TKW_NT / 32);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (k <= 8) {
    topk_warp_kernel<8><<<wblocks, TKW_NT, 0, st>>>(xf, rows, n, k, v, id, vec4);
  } else if (k <= 32) {
    topk_warp_kernel<32><<<wblocks, TKW_NT, 0, st>>>(xf, rows, n, k, v, id, vec4);
  } else {
    return static_cast<int>(topk_long<0>(xf, rows, n, k, v, id, st));
  }
  return static_cast<int>(cudaGetLastError());
}

