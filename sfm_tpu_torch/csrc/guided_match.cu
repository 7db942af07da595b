// Kernel K1-g: guided 2D-3D matching of one image's keypoints against the
// model's observation pool, with the Lowe ratio taken against the best entry
// of a DIFFERENT track.
//
// Replaces sfm_tpu/reconstruction/incremental.py::_guided_match (:159), which
// writes the (K, M) distance matrix to device memory and reads it back for the
// row min/argmin, the track gather and the masked "other track" min.
//
// What bounds it on the H100: float32 FMAs, 2 * K * M * D (4.3 GFLOP at
// K = 2048, M = 8192, D = 128); it runs once per rescue attempt.
//
// Design: K1's tiles (dot_tile.cuh), one block per 64 keypoints streaming the
// pool's columns. The per-row state (best, best index, best track, best over
// the other tracks) merges associatively, so each thread folds its columns in
// and the 16 lanes sharing a row merge with shuffles, as K1 does:
//   same track:      keep the lexicographically lower (best, index), and the
//                    min of the two "other" values;
//   different track: the winner keeps its "other", min'd with the loser's best.
// Ties follow jnp.argmin (lowest index); an all-inf row returns index 0, so its
// track is pool_track[0]; ok uses the reference's strict <.
#include "dot_tile.cuh"

namespace {

using namespace sfm_tile;

struct Guided {
  float best;
  int idx;
  int track;
  float other;  // min distance over entries whose track differs from `track`
};

__device__ __forceinline__ Guided guided_merge(const Guided& a, const Guided& b) {
  const bool b_wins = b.best < a.best || (b.best == a.best && b.idx < a.idx);
  const Guided& w = b_wins ? b : a;
  const Guided& l = b_wins ? a : b;
  const float other = w.track == l.track ? fminf(w.other, l.other) : fminf(w.other, l.best);
  return Guided{w.best, w.idx, w.track, other};
}

__global__ void __launch_bounds__(NT) guided_match_kernel(
    const float* __restrict__ desc, const uint8_t* __restrict__ valid,
    const float* __restrict__ pool, const uint8_t* __restrict__ pool_valid,
    const int* __restrict__ pool_track, int K, int M, int D, float r2,
    int* __restrict__ t_best, float* __restrict__ d_best, uint8_t* __restrict__ ok) {
  __shared__ Stage stage;
  const int r0 = blockIdx.x * TR;

  // The empty state: an index past every column and a track no entry has
  // (so the first real entry always counts as "another track").
  Guided st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = Guided{INFINITY, INT_MAX, INT_MIN, INFINITY};

  for (int c0 = 0; c0 < M; c0 += TC) {
    float acc[4][4];
    dots(stage, desc, K, r0, pool, M, c0, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx() + 16 * j;
      if (col >= M) continue;
      const bool col_ok = pool_valid[col] != 0;
      const int trk = pool_track[col];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st[i] = guided_merge(st[i], Guided{distance(acc[i][j], col_ok), col, trk, INFINITY});
    }
  }

#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Guided o;
      o.best = __shfl_xor_sync(0xffffffffu, st[i].best, off);
      o.idx = __shfl_xor_sync(0xffffffffu, st[i].idx, off);
      o.track = __shfl_xor_sync(0xffffffffu, st[i].track, off);
      o.other = __shfl_xor_sync(0xffffffffu, st[i].other, off);
      st[i] = guided_merge(st[i], o);
    }
  }
  if (tx() == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty() + 16 * i;
      if (row >= K) continue;
      const bool row_ok = valid[row] != 0;
      const float best = row_ok ? st[i].best : INFINITY;
      const int idx = (row_ok && st[i].idx != INT_MAX) ? st[i].idx : 0;
      t_best[row] = pool_track[idx];
      d_best[row] = best;
      ok[row] = row_ok && isfinite(best) && best < r2 * st[i].other;
    }
  }
}

}  // namespace

SFM_API int sfm_guided_match(const void* desc, const void* valid, const void* pool,
                             const void* pool_valid, const void* pool_track, int K, int M,
                             int D, float r2, void* t_best, void* d_best, void* ok,
                             void* stream) {
  if (D % TK || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K > 0) {
    guided_match_kernel<<<(K + TR - 1) / TR, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(desc), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(pool), static_cast<const uint8_t*>(pool_valid),
        static_cast<const int*>(pool_track), K, M, D, r2, static_cast<int*>(t_best),
        static_cast<float*>(d_best), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
