// Kernel K1: per-row top-2 of the squared-L2 descriptor distance, batched over pairs.
//
// Replaces the distance/top-2 part of sfm_tpu/matching/core.py::_match_descriptors
// (the XLA program the sweep vmaps over chunks of 32 pairs) and, with the two
// entries below, the rest of it (:81-105): there a (K1, K2) f32 distance matrix
// is written to device memory and read back by the row min-passes and the
// column argmin. Here the matrix never leaves the block.
//
// What bounds it on the H100: float32 FMAs on the CUDA cores (2*K1*K2*D per
// pair, both directions from one product; 1.07 GFLOP at K = 2048, D = 128).
// The tensor cores would need TF32/bf16 inputs, which the port does not allow
// on descriptors. The epilogue entries move ~20 bytes a row.
//
// Design: one block per (pair, 128 query rows), 256 threads, each thread an
// 8 x 8 register tile of dot products (rows ty + 16 i, columns tx + 16 j).
// The block's 128 rows stay in dynamic shared memory for the whole sweep
// (row-major, a row padded by 16 bytes); the other set's columns stream
// through a three-stage cp.async ring of 128 columns x 32 floats, so the next
// stage's copy runs under this stage's FMAs. A thread reads four depths of
// each of its rows and columns as one float4 a row or column: 16 loads feed
// 256 FMAs, and the padding keeps the 16-byte loads of eight lanes in
// distinct banks. Each dot product is fmaf over k = 0 .. D-1 in order from
// 0.f (as dot_tile.cuh's), so every distance has the same bits whatever the
// tiling. After a column tile each thread folds its 64 distances into a
// running top-2 a row, and takes its columns' keys over its eight rows; the
// two lanes of a column in a warp meet by a shuffle, the eight warps in
// shared memory, and one global atomicMin a column goes out per block (half
// the first design's count: 128 rows a block instead of 64). The 16 lanes
// that share a row merge their top-2 with warp shuffles at the end. D up to
// kResidentMaxD (the rows fit beside the ring in the 227 KB a block may
// take); a larger D, or descriptors that are not 16-byte aligned, take the
// first design (dot_tile.cuh's 64 x 64 tiles), which gives the same bits.
//
// Semantics (the plain twin's, i.e. jnp.min/argmin): d = max(2 - 2 a.b, 0), +inf
// for an invalid column and for every column of an invalid row; ties go to the
// lowest column index; an all-inf row returns index 0; "second" is the minimum
// over every column but the best one (equal to best on a tie).
//
// The mutual check's column argmin back = argmin(dist, axis=0) comes from the
// same tiles when the caller asks for it: each column's key is the u64
// (float bits << 32 | row). Distances are >= 0 or +inf, so the keys order as
// (distance, row) and the minimum is jnp.argmin's lowest-row tie; an invalid
// row pushes +inf, so a column that is +inf in every row gets row 0.
//
// match_epilogue (second entry) is the rest of _match_descriptors up to the
// compaction: the Lowe ratio, the mutual test back[best_j] == row and the
// score -d_best (or -inf) that topk_rows compacts; match_compact (third entry)
// is the compaction's gathers and wheres after topk_rows. One thread per row.
#include "dot_tile.cuh"

namespace {

using namespace sfm_tile;

__global__ void __launch_bounds__(NT) match_top2_kernel(
    const float* __restrict__ d1, const uint8_t* __restrict__ v1,
    const float* __restrict__ d2, const uint8_t* __restrict__ v2,
    int K1, int K2, int D,
    int* __restrict__ out_idx, float* __restrict__ out_best,
    float* __restrict__ out_second, unsigned long long* __restrict__ back_key) {
  __shared__ Stage stage;
  __shared__ unsigned long long s_col[TC];

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TR;
  const float* A = d1 + (size_t)b * K1 * D;
  const float* Bm = d2 + (size_t)b * K2 * D;
  const uint8_t* vcol = v2 + (size_t)b * K2;

  const bool want_back = back_key != nullptr;
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty() + 16 * i;
    row_ok[i] = row < K1 && v1[(size_t)b * K1 + row] != 0;
  }
  if (threadIdx.x < TC) s_col[threadIdx.x] = kKeyMax;

  Top2 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = top2_empty();

  for (int c0 = 0; c0 < K2; c0 += TC) {
    float acc[4][4];
    dots(stage, A, K1, r0, Bm, K2, c0, D, acc);  // its barriers order s_col's reset
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // increasing column order
      const int gc = c0 + tx() + 16 * j;
      const bool col_ok = gc < K2 && vcol[gc] != 0;
      unsigned long long key = kKeyMax;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = distance(acc[i][j], col_ok);
        if (gc < K2) top2_push(top[i], d, gc);
        const int row = r0 + ty() + 16 * i;
        if (row < K1) key = min(key, col_key(row_ok[i] ? d : INFINITY, row));
      }
      if (want_back) {
        // Lanes l and l ^ 16 hold the same column (ty and ty + 1).
        key = min(key, __shfl_xor_sync(0xffffffffu, key, 16));
        if (gc < K2 && (threadIdx.x & 16) == 0) atomicMin(&s_col[tx() + 16 * j], key);
      }
    }
    if (want_back) {
      __syncthreads();
      if (threadIdx.x < TC) {
        const int gc = c0 + threadIdx.x;
        if (gc < K2) atomicMin(&back_key[(size_t)b * K2 + gc], s_col[threadIdx.x]);
        s_col[threadIdx.x] = kKeyMax;
      }
    }
  }

  top2_merge_lanes(top);
  if (tx() == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty() + 16 * i;
      if (row >= K1) continue;
      const size_t o = (size_t)b * K1 + row;
      out_idx[o] = (row_ok[i] && top[i].idx != INT_MAX) ? top[i].idx : 0;
      out_best[o] = row_ok[i] ? top[i].best : INFINITY;
      out_second[o] = row_ok[i] ? top[i].second : INFINITY;
    }
  }
}

// ---- The resident-rows kernel (see the header) ----------------------------
constexpr int RR = 128;           // rows a block (resident)
constexpr int RC = 128;           // columns a streamed tile
constexpr int RK = 32;            // depth a ring stage
constexpr int RSTAGES = 3;        // ring stages
constexpr int RB_STRIDE = RK + 4; // a column's floats in a stage (16 bytes of padding)
constexpr int RNT = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr size_t kRingBytes = (size_t)RSTAGES * RC * RB_STRIDE * sizeof(float);
constexpr size_t kKeyBytes = (size_t)(RNT / 32) * RC * sizeof(unsigned long long);
constexpr int kResidentMaxD = 320;  // 128 x (D + 4) floats + the ring + the keys <= 227 KB

size_t resident_smem(int D) {
  return (size_t)RR * (D + 4) * sizeof(float) + kRingBytes + kKeyBytes;
}

__global__ void __launch_bounds__(RNT, 1) match_top2_resident_kernel(
    const float* __restrict__ d1, const uint8_t* __restrict__ v1,
    const float* __restrict__ d2, const uint8_t* __restrict__ v2,
    int K1, int K2, int D,
    int* __restrict__ out_idx, float* __restrict__ out_best,
    float* __restrict__ out_second, unsigned long long* __restrict__ back_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = D + 4;  // a resident row's floats
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (size_t)RR * SA;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(Bs + RSTAGES * RC * RB_STRIDE);

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * RR;
  const float* A = d1 + (size_t)b * K1 * D;
  const float* Bm = d2 + (size_t)b * K2 * D;
  const uint8_t* vcol = v2 + (size_t)b * K2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const bool want_back = back_key != nullptr;

  const int nks = D / RK, nct = (K2 + RC - 1) / RC, nsteps = nks * nct;
  // Stage s of the ring: column tile s / nks, depths (s % nks) * RK ..; a
  // thread copies four 16-byte pieces (eight threads a column's 128 bytes).
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int c0 = (s / nks) * RC, k0 = (s % nks) * RK;
      float* dst = Bs + (s % RSTAGES) * RC * RB_STRIDE;
#pragma unroll
      for (int q = 0; q < RC * RK / 4 / RNT; ++q) {
        const int e = threadIdx.x + q * RNT, col = e / (RK / 4), kq = e % (RK / 4);
        const int gc = c0 + col;
        cp_async16(dst + col * RB_STRIDE + kq * 4,
                   gc < K2 ? Bm + (size_t)gc * D + k0 + kq * 4 : Bm, gc < K2);
      }
    }
    cp_async_commit();
  };
  // The block's rows (zeros past K1), in the first group with stage 0.
  for (int e = threadIdx.x; e < RR * (D / 4); e += RNT) {
    const int r = e / (D / 4), kq = e % (D / 4), gr = r0 + r;
    cp_async16(As + r * SA + kq * 4, gr < K1 ? A + (size_t)gr * D + kq * 4 : A, gr < K1);
  }
#pragma unroll
  for (int s = 0; s < RSTAGES - 1; ++s) issue(s);

  bool row_ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty + 16 * i;
    row_ok[i] = row < K1 && v1[(size_t)b * K1 + row] != 0;
  }
  Top2 top[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) top[i] = top2_empty();
  float acc[8][8];

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<RSTAGES - 2>();  // stage s (and the rows) landed for this thread
    __syncthreads();               // ... for every thread; slot (s - 1) % RSTAGES is free
    issue(s + RSTAGES - 1);
    const int kt = s % nks;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* Bt = Bs + (s % RSTAGES) * RC * RB_STRIDE;
    const float* At = As + kt * RK;
#pragma unroll
    for (int kk = 0; kk < RK; kk += 4) {
      float4 a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(At + (ty + 16 * i) * SA + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * RB_STRIDE + kk);
      // A depth at a time over all 64 sums: each sum's FMAs stay in k order,
      // and 64 independent FMAs separate two of them.
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
    if (kt != nks - 1) continue;
    // The column tile's epilogue.
    const int c0 = (s / nks) * RC;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // increasing column order
      const int gc = c0 + tx + 16 * j;
      const bool col_ok = gc < K2 && vcol[gc] != 0;
      float kd = INFINITY;
      int kr = -1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // increasing row order: the first minimum is the lowest row
        const float d = distance(acc[i][j], col_ok);
        if (gc < K2) top2_push_ascending(top[i], d, gc);
        const int row = r0 + ty + 16 * i;
        const float dk = row_ok[i] ? d : INFINITY;
        const bool take = row < K1 && (kr < 0 || dk < kd);
        kd = take ? dk : kd;
        kr = take ? row : kr;
      }
      if (want_back) {
        unsigned long long key = kr < 0 ? kKeyMax : col_key(kd, kr);
        // Lanes l and l ^ 16 hold the same column (ty and ty + 1).
        key = min(key, __shfl_xor_sync(0xffffffffu, key, 16));
        if ((threadIdx.x & 16) == 0) s_key[warp * RC + tx + 16 * j] = key;
      }
    }
    if (want_back) {
      __syncthreads();
      if (threadIdx.x < RC) {
        const int gc = c0 + threadIdx.x;
        unsigned long long key = kKeyMax;
#pragma unroll
        for (int w = 0; w < RNT / 32; ++w) key = min(key, s_key[w * RC + threadIdx.x]);
        if (gc < K2) atomicMin(&back_key[(size_t)b * K2 + gc], key);
      }
      // s_key is written again only after the next step's barrier.
    }
  }
  cp_async_wait<0>();

  // Merge the 16 lanes tx = 0..15 of each half-warp, which share rows ty + 16 i.
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
      if (row >= K1) continue;
      const size_t o = (size_t)b * K1 + row;
      out_idx[o] = (row_ok[i] && top[i].idx != INT_MAX) ? top[i].idx : 0;
      out_best[o] = row_ok[i] ? top[i].best : INFINITY;
      out_second[o] = row_ok[i] ? top[i].second : INFINITY;
    }
  }
}

// back = the row of each column's minimum key (the low 32 bits).
__global__ void __launch_bounds__(256) back_index_kernel(
    const unsigned long long* __restrict__ key, int n, int* __restrict__ back) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) back[i] = (int)(unsigned)(key[i] & 0xffffffffull);
}

__global__ void __launch_bounds__(256) match_epilogue_kernel(
    const int* __restrict__ best_j, const float* __restrict__ d_best,
    const float* __restrict__ d_second, const uint8_t* __restrict__ v1,
    const int* __restrict__ back, int B, int K1, int K2, float ratio2,
    float* __restrict__ score) {
  const int g = blockIdx.x * 256 + threadIdx.x;
  if (g >= B * K1) return;
  const int b = g / K1, row = g % K1;
  const float db = d_best[g];
  bool good = db < ratio2 * d_second[g] && v1[g] != 0 && isfinite(db);
  if (back != nullptr) good = good && back[(size_t)b * K2 + best_j[g]] == row;
  score[g] = good ? -db : -INFINITY;
}

__global__ void __launch_bounds__(256) match_compact_kernel(
    const float* __restrict__ top, const int64_t* __restrict__ order,
    const int* __restrict__ best_j, int B, int K1, int k, int M,
    int64_t* __restrict__ idx1, int64_t* __restrict__ idx2, uint8_t* __restrict__ valid,
    float* __restrict__ dist) {
  const int g = blockIdx.x * 256 + threadIdx.x;
  if (g >= B * M) return;
  const int b = g / M, m = g % M;
  const float s = m < k ? top[(size_t)b * k + m] : -INFINITY;
  const bool ok = isfinite(s);
  const int o = ok ? (int)order[(size_t)b * k + m] : 0;
  idx1[g] = o;
  idx2[g] = ok ? best_j[(size_t)b * K1 + o] : 0;
  valid[g] = ok;
  dist[g] = ok ? -s : 0.f;
}

}  // namespace

// Once, on the first launch: the resident-rows kernel may take the
// device's opt-in shared memory (227 KB on the H100).
SFM_API int sfm_match_setup(void* /*stream*/) {
  return static_cast<int>(cudaFuncSetAttribute(match_top2_resident_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)resident_smem(kResidentMaxD)));
}

SFM_API int sfm_match_top2(const void* d1, const void* v1, const void* d2,
                           const void* v2, int B, int K1, int K2, int D,
                           void* idx, void* best, void* second, void* back_key, void* back,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* key = static_cast<unsigned long long*>(back_key);
  if (key != nullptr) {
    const cudaError_t e = cudaMemsetAsync(key, 0xff, (size_t)B * K2 * sizeof(*key), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool resident = D % RK == 0 && D <= kResidentMaxD &&
                        reinterpret_cast<uintptr_t>(d1) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(d2) % 16 == 0;
  if (B > 0 && K1 > 0 && resident) {
    const dim3 grid((K1 + RR - 1) / RR, B);
    match_top2_resident_kernel<<<grid, RNT, resident_smem(D), st>>>(
        static_cast<const float*>(d1), static_cast<const uint8_t*>(v1),
        static_cast<const float*>(d2), static_cast<const uint8_t*>(v2), K1, K2, D,
        static_cast<int*>(idx), static_cast<float*>(best), static_cast<float*>(second), key);
  } else if (B > 0 && K1 > 0) {
    const dim3 grid((K1 + TR - 1) / TR, B);
    match_top2_kernel<<<grid, NT, 0, st>>>(
        static_cast<const float*>(d1), static_cast<const uint8_t*>(v1),
        static_cast<const float*>(d2), static_cast<const uint8_t*>(v2), K1, K2, D,
        static_cast<int*>(idx), static_cast<float*>(best), static_cast<float*>(second), key);
  }
  if (key != nullptr && B * K2 > 0) {
    back_index_kernel<<<(B * K2 + 255) / 256, 256, 0, st>>>(key, B * K2,
                                                            static_cast<int*>(back));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_match_epilogue(const void* best_j, const void* d_best, const void* d_second,
                               const void* v1, const void* back, int B, int K1, int K2,
                               float ratio2, void* score, void* stream) {
  if (B * K1 > 0) {
    match_epilogue_kernel<<<(B * K1 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(best_j), static_cast<const float*>(d_best),
        static_cast<const float*>(d_second), static_cast<const uint8_t*>(v1),
        static_cast<const int*>(back), B, K1, K2, ratio2, static_cast<float*>(score));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_match_compact(const void* top, const void* order, const void* best_j, int B,
                              int K1, int k, int M, void* idx1, void* idx2, void* valid,
                              void* dist, void* stream) {
  if (B * M > 0) {
    match_compact_kernel<<<(B * M + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(top), static_cast<const int64_t*>(order),
        static_cast<const int*>(best_j), B, K1, k, M, static_cast<int64_t*>(idx1),
        static_cast<int64_t*>(idx2), static_cast<uint8_t*>(valid), static_cast<float*>(dist));
  }
  return static_cast<int>(cudaGetLastError());
}
