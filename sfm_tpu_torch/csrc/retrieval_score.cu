// Kernel K1-r: the retrieval score of a candidate pair, its mutual ratio-test
// match count over both images' top-S keypoints.
//
// Replaces sfm_tpu/matching/retrieval.py::_score_chunk (:37), which vmaps a
// (S, S) distance matrix per pair of a 1,024-pair chunk through device memory
// (plus the row top-2 passes and a column argmin pass) to return one int32.
//
// What bounds it on the H100: float32 FMAs, 2 * S^2 * D per pair (16.8 MFLOP at
// S = 256, D = 128); the 11,175 pairs of a 150-image scene are 0.19 TFLOP.
// The tensor cores would need TF32/bf16 inputs, which the port does not allow
// on descriptors.
//
// Two designs, the same bits (every dot product is fmaf over k = 0 .. D-1 in
// order from 0.f and every distance dot_tile.cuh's distance(), so every
// distance, tie and count is the same):
//
// The resident design (S <= 256, D <= 128 and a multiple of 32, at least two
// ring stages a unit below, the table 16-byte aligned: the retrieval sweep's
// S = 256, D = 128): a persistent grid, one block of 256 threads an SM, block g
// taking pairs g, g + grid, ... A pair is one or two units of 128 rows; a
// unit's rows sit in one of two resident buffers (row-major, a row padded by
// 16 bytes), loaded by cp.async with the ring stage that starts the unit, so
// the next unit's rows land under this unit's FMAs. The pair's columns stream
// through a three-stage cp.async ring of 128 columns x 32 floats, as K1's
// match_top2.cu: each thread an 8 x 8 register tile fed by float4 loads that
// the padding keeps in distinct banks, 16 loads to 256 FMAs. After a column
// tile each thread folds its 64 distances into a running top-2 a row and its
// columns' (distance, row) minima as u64 keys (float bits << 32 | row); the
// two lanes of a column meet by a shuffle, each warp writes its row of keys,
// and after a barrier 128 threads fold the eight warps' rows into the pair's
// column keys (a 64-bit shared-memory atomicMin would be a compare-and-swap
// loop). At the pair's end the rows' top-2 and the column keys give the
// mutual count in the block.
//
// The first design (every other shape: S up to 1,024, D = 256, unaligned
// descriptors): one block per pair, no gathered copies: the block reads both
// images' descriptors from the (N, S, D) table. It walks the S x S matrix in
// the 64 x 64 tiles of dot_tile.cuh, row tile by row tile. Within a row tile
// each thread keeps the running top-2 of its rows (as K1); after every tile the
// per-column lexicographic (distance, row) minimum of the tile is reduced
// through shared memory into the column state of all S columns. When every
// tile is done, both directions are complete in shared memory and the mutual
// test back[best] == i is a lookup; the block's count is one atomic per thread
// into shared memory.
//
// Semantics follow the twin (jnp.min/argmin ties: the lowest index; an
// all-inf column's argmin is row 0).
#include "dot_tile.cuh"

#ifndef SFM_ST  // clock64 probes (tests/describe_stamps.py defines them)
#define SFM_ST_INIT(idx, on)
#define SFM_ST(slot)
#define SFM_ST_END
#endif

namespace {

using namespace sfm_tile;

constexpr int MAX_S = 1024;

__global__ void __launch_bounds__(NT) retrieval_score_kernel(
    const float* __restrict__ desc, const uint8_t* __restrict__ valid,
    const int* __restrict__ pairs, int S, int D, float r2, int* __restrict__ counts) {
  __shared__ Stage stage;
  __shared__ float row_best[MAX_S], row_second[MAX_S], col_best[MAX_S];
  __shared__ int row_idx[MAX_S], col_idx[MAX_S];
  __shared__ float red_d[16][TC];
  __shared__ int red_i[16][TC];
  __shared__ int total;

  const int p = blockIdx.x;
  const int a = pairs[2 * p], b = pairs[2 * p + 1];
  const float* A = desc + (size_t)a * S * D;
  const float* B = desc + (size_t)b * S * D;
  const uint8_t* va = valid + (size_t)a * S;
  const uint8_t* vb = valid + (size_t)b * S;

  for (int k = threadIdx.x; k < S; k += NT) {
    col_best[k] = INFINITY;
    col_idx[k] = INT_MAX;
  }
  if (threadIdx.x == 0) total = 0;
  __syncthreads();

  for (int r0 = 0; r0 < S; r0 += TR) {
    Top2 top[4];
    bool row_ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      top[i] = top2_empty();
      const int row = r0 + ty() + 16 * i;
      row_ok[i] = row < S && va[row] != 0;
    }
    for (int c0 = 0; c0 < S; c0 += TC) {
      float acc[4][4];
      dots(stage, A, S, r0, B, S, c0, D, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx() + 16 * j;
        const bool col_ok = col < S && vb[col] != 0;
        float cb = INFINITY;
        int ci = INT_MAX;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ty() + 16 * i;
          const float d = distance(acc[i][j], row_ok[i] && col_ok);
          if (col < S) top2_push(top[i], d, col);
          if (row < S && (d < cb || (d == cb && row < ci))) {
            cb = d;
            ci = row;
          }
        }
        red_d[ty()][tx() + 16 * j] = cb;
        red_i[ty()][tx() + 16 * j] = ci;
      }
      __syncthreads();
      if (threadIdx.x < TC && c0 + threadIdx.x < S) {
        const int col = c0 + threadIdx.x;
        float cb = col_best[col];
        int ci = col_idx[col];
        for (int t = 0; t < 16; ++t) {
          const float d = red_d[t][threadIdx.x];
          const int i = red_i[t][threadIdx.x];
          if (d < cb || (d == cb && i < ci)) {
            cb = d;
            ci = i;
          }
        }
        col_best[col] = cb;
        col_idx[col] = ci;
      }
      // The next tile's dots() synchronizes before red_* is written again.
    }
    top2_merge_lanes(top);
    if (tx() == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty() + 16 * i;
        if (row >= S) continue;
        row_best[row] = top[i].best;
        row_idx[row] = top[i].idx;
        row_second[row] = top[i].second;
      }
    }
  }
  __syncthreads();

  int n = 0;
  for (int row = threadIdx.x; row < S; row += NT) {
    const float best = row_best[row];
    if (va[row] == 0 || !isfinite(best) || !(best < r2 * row_second[row])) continue;
    const int back = col_idx[row_idx[row]];
    n += (back == INT_MAX ? 0 : back) == row;
  }
  if (n) atomicAdd(&total, n);
  __syncthreads();
  if (threadIdx.x == 0) counts[p] = total;
}


// ---- The resident design (see the header) ---------------------------------
constexpr int RR = 128;            // rows a unit (resident)
constexpr int RC = 128;            // columns a streamed tile
constexpr int RK = 32;             // depth a ring stage
constexpr int RSTAGES = 3;         // ring stages
constexpr int RB_STRIDE = RK + 4;  // a column's floats in a stage (16 bytes of padding)
constexpr int RNT = 256;           // 16 x 16 threads, 8 x 8 outputs each
constexpr int kResMaxS = 2 * RR;   // rows (and columns) of a pair
constexpr int kResMaxD = 128;

// Two units' rows, the ring, the pair's column keys and its rows' top-2, and
// the warps' key rows of a column tile (203,776 bytes at D = 128).
size_t resident_smem(int D) {
  return (size_t)2 * RR * (D + 4) * sizeof(float) +
         (size_t)RSTAGES * RC * RB_STRIDE * sizeof(float) +
         (size_t)kResMaxS * (sizeof(unsigned long long) + 2 * sizeof(float) + sizeof(int)) +
         (size_t)(RNT / 32) * RC * sizeof(unsigned long long);
}

bool resident_shape(int S, int D, const void* desc) {
  return S <= kResMaxS && D <= kResMaxD && D % RK == 0 &&
         ((S + RC - 1) / RC) * (D / RK) >= RSTAGES - 1 &&
         reinterpret_cast<uintptr_t>(desc) % 16 == 0;
}

__global__ void __launch_bounds__(RNT, 1) retrieval_resident_kernel(
    const float* __restrict__ desc, const uint8_t* __restrict__ valid,
    const int* __restrict__ pairs, int S, int D, int C, float r2, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = D + 4;  // a resident row's floats
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + 2 * RR * SA;
  unsigned long long* s_col =
      reinterpret_cast<unsigned long long*>(Bs + RSTAGES * RC * RB_STRIDE);
  float* row_best = reinterpret_cast<float*>(s_col + kResMaxS);
  float* row_second = row_best + kResMaxS;
  int* row_idx = reinterpret_cast<int*>(row_second + kResMaxS);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(row_idx + kResMaxS);
  __shared__ int s_total;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  SFM_ST_INIT(blockIdx.x, tid == 0)
  // A pair is `halves` units of RR rows; a unit `spu` ring stages: the column
  // tiles, each in D / RK depth slices.
  const int halves = (S + RR - 1) / RR, nks = D / RK, spu = ((S + RC - 1) / RC) * nks;
  const int npairs = (int)blockIdx.x < C ? (C - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nsteps = npairs * halves * spu;
  auto pair_of = [&](int u) { return (int)blockIdx.x + (u / halves) * (int)gridDim.x; };
  // Stage s of the ring: unit s / spu; a thread copies four 16-byte pieces
  // (eight threads a column's 128 bytes). A unit's rows (zeros past S) ride
  // with its first stage, into buffer u % 2: issued RSTAGES - 1 stages ahead,
  // after the unit two before it (at least RSTAGES - 1 stages long) is done.
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int u = s / spu, st = s % spu, p = pair_of(u);
      const float* Bm = desc + (size_t)__ldg(pairs + 2 * p + 1) * S * D;
      const int c0 = (st / nks) * RC, k0 = (st % nks) * RK;
      float* dst = Bs + (s % RSTAGES) * RC * RB_STRIDE;
#pragma unroll
      for (int q = 0; q < RC * RK / 4 / RNT; ++q) {
        const int e = tid + q * RNT, col = e / (RK / 4), kq = e % (RK / 4);
        const int gc = c0 + col;
        cp_async16(dst + col * RB_STRIDE + kq * 4,
                   gc < S ? Bm + (size_t)gc * D + k0 + kq * 4 : Bm, gc < S);
      }
      if (st == 0) {
        const int r0 = (u % halves) * RR;
        const float* A = desc + (size_t)__ldg(pairs + 2 * p) * S * D;
        float* Ad = As + (u & 1) * RR * SA;
        for (int e = tid; e < RR * (D / 4); e += RNT) {
          const int r = e / (D / 4), kq = e % (D / 4), gr = r0 + r;
          cp_async16(Ad + r * SA + kq * 4, gr < S ? A + (size_t)gr * D + kq * 4 : A, gr < S);
        }
      }
    }
    cp_async_commit();
  };
  for (int c = tid; c < kResMaxS; c += RNT) s_col[c] = kKeyMax;
  if (tid == 0) s_total = 0;
#pragma unroll
  for (int s = 0; s < RSTAGES - 1; ++s) issue(s);
  SFM_ST(0)

  Top2 top[8];
  bool row_ok[8];
  float acc[8][8];
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<RSTAGES - 2>();  // stage s (and its unit's rows) landed for this thread
    __syncthreads();               // ... for every thread; slot (s - 1) % RSTAGES is free
    issue(s + RSTAGES - 1);
    SFM_ST(6)
    const int u = s / spu, st = s % spu, kt = st % nks, p = pair_of(u);
    const int r0 = (u % halves) * RR;
    const uint8_t* va = valid + (size_t)__ldg(pairs + 2 * p) * S;
    if (st == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ty + 16 * i;
        row_ok[i] = row < S && va[row] != 0;
        top[i] = top2_empty();
      }
    }
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* Bt = Bs + (s % RSTAGES) * RC * RB_STRIDE;
    const float* At = As + (u & 1) * RR * SA + kt * RK;
#pragma unroll
    for (int kk = 0; kk < RK; kk += 4) {
      float4 a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(At + (ty + 16 * i) * SA + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * RB_STRIDE + kk);
      // A depth at a time over all 64 sums: each sum's FMAs stay in k order.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
    }
    SFM_ST(1)
    if (kt != nks - 1) continue;
    // The column tile's epilogue: the rows' top-2 and the columns' keys.
    const int c0 = (st / nks) * RC;
    const uint8_t* vb = valid + (size_t)__ldg(pairs + 2 * p + 1) * S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // increasing column order
      const int gc = c0 + tx + 16 * j;
      const bool col_ok = gc < S && vb[gc] != 0;
      float kd = INFINITY;
      int kr = -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // increasing row order: the first minimum is the lowest row
        const float d = distance(acc[i][j], col_ok);
        if (gc < S) top2_push_ascending(top[i], d, gc);
        const int row = r0 + ty + 16 * i;
        const float dk = row_ok[i] ? d : INFINITY;
        const bool take = row < S && (kr < 0 || dk < kd);
        kd = take ? dk : kd;
        kr = take ? row : kr;
      }
      unsigned long long key = kr < 0 ? kKeyMax : col_key(kd, kr);
      // Lanes l and l ^ 16 hold the same column (ty and ty + 1).
      key = min(key, __shfl_xor_sync(0xffffffffu, key, 16));
      if ((tid & 16) == 0) s_key[(tid / 32) * RC + tx + 16 * j] = key;
    }
    __syncthreads();
    if (tid < RC && c0 + tid < S) {
      unsigned long long key = s_col[c0 + tid];
#pragma unroll
      for (int w = 0; w < RNT / 32; ++w) key = min(key, s_key[w * RC + tid]);
      s_col[c0 + tid] = key;
    }
    SFM_ST(2)
    if (st != spu - 1) continue;
    // The unit's rows: merge the 16 lanes tx = 0..15 that share rows ty + 16 i.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        Top2 o;
        o.best = __shfl_xor_sync(0xffffffffu, top[i].best, off);
        o.idx = __shfl_xor_sync(0xffffffffu, top[i].idx, off);
        o.second = __shfl_xor_sync(0xffffffffu, top[i].second, off);
        top[i] = top2_merge(top[i], o);
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row >= S) continue;
        row_best[row] = top[i].best;
        row_idx[row] = top[i].idx;
        row_second[row] = top[i].second;
      }
    }
    SFM_ST(4)
    if (u % halves != halves - 1) continue;
    // The pair's mutual count (a row whose best is +inf keeps idx INT_MAX and
    // is not counted).
    __syncthreads();
    int n = 0;
    for (int row = tid; row < S; row += RNT) {
      const float best = row_best[row];
      if (va[row] == 0 || !isfinite(best) || !(best < r2 * row_second[row])) continue;
      n += (int)(unsigned)(s_col[row_idx[row]] & 0xffffffffull) == row;
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if (tid % 32 == 0 && n) atomicAdd(&s_total, n);
    __syncthreads();
    if (tid == 0) {
      counts[p] = s_total;
      s_total = 0;
    }
    for (int c = tid; c < S; c += RNT) s_col[c] = kKeyMax;
    SFM_ST(5)
    // The next pair's keys are written after the next stage's barrier.
  }
  cp_async_wait<0>();
  SFM_ST_END
}

}  // namespace

// Once, on the first launch: the resident design takes the device's opt-in
// shared memory.
SFM_API int sfm_retrieval_setup(void* /*stream*/) {
  return static_cast<int>(cudaFuncSetAttribute(retrieval_resident_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)resident_smem(kResMaxD)));
}

SFM_API int sfm_retrieval_score(const void* desc, const void* valid, const void* pairs,
                                int N, int S, int D, int C, float r2, void* counts,
                                void* stream) {
  (void)N;
  if (S > MAX_S || D % TK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 0 && resident_shape(S, D, desc)) {
    // A persistent grid: a block an SM (one fits), each walking its pairs.
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    retrieval_resident_kernel<<<C < sms ? C : sms, RNT, resident_smem(D), st>>>(
        static_cast<const float*>(desc), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(pairs), S, D, C, r2, static_cast<int*>(counts));
  } else if (C > 0) {
    retrieval_score_kernel<<<C, NT, 0, st>>>(
        static_cast<const float*>(desc), static_cast<const uint8_t*>(valid),
        static_cast<const int*>(pairs), S, D, r2, static_cast<int*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
