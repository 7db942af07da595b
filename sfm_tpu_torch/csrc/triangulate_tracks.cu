// Kernel K7: robust multi-view triangulation of track rows, and the per-slot
// reprojection error (two entries).
//
// Replaces sfm_tpu/reconstruction/incremental.py::_triangulate_tracks (:48,
// the vmapped `one` of :83-152) and _reproj_stats (:183). There each track's
// V views, 28 seed-pair hypotheses and drop-and-resolve rounds are vmapped
// tensor programs with (T, 28, V) intermediates in device memory; here one
// warp does a whole track row in registers:
//   joint DLT over the usable views (row-normalized 4x4 normal matrix, smallest
//   eigenvector by 8 steps of inverse iteration with the adjugate, as
//   utils/linalg.py::_smallest_eigvec_adjugate); with seed pairs on, the
//   C(n_seed, 2) two-view hypotheses over the n_seed even-stride usable views,
//   each scored by inliers over all usable views, adopted when it beats the
//   joint solve with >= 3 inliers; `robust_rounds` drop-and-resolve rounds;
//   then the gates (>= 2 views, all in front, max error <= max_err, optional
//   parallax). The usable-view set is a bit mask (V <= 256).
// sfm_reproj_stats: one thread per (track, slot).
//
// What bounds it on the H100: latency. The first design ran a row on one
// thread (a 2,048-row bucket was 16 blocks for 132 SMs, with 28 serial
// two-view solves a row when seed pairs are on). Now a warp takes a row:
// lanes take the views (each view's DLT rows, projection, error and depth),
// the counts and masks are ballots, the seed views a scan of the mask, a lane
// takes a hypothesis (its solve, then its inliers over the usable views) and
// the first best wins by a warp argmax (highest score, then lowest index, as
// the serial loop's strict ">" and jnp.argmax pick). The 4x4 normal matrix is
// still summed view by view in view order (the lanes' rows broadcast in
// turn, every lane summing alike), and every float expression is the first
// design's, so points and flags keep their bits. A warp a row runs each 4x4
// solve on every lane, so where a launch has rows enough to fill the card and
// no seed pairs (a whole table: 21,267 rows on the 150-view corridor) the
// first design, a thread a row, is the faster: `layout` 1 runs it, with the
// same expressions, and the wrapper picks it by the launch's shape. The host
// keeps the bucket/chunk logic.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 128;
constexpr int ROWS = NT / 32;  // a warp a row
constexpr int MASK_WORDS = 8;  // V <= 256
constexpr int MAX_SEED = 32;   // n_seed <= 32 when seed pairs are on
constexpr unsigned FULL = 0xffffffffu;

// The words are only ever indexed by unrolled loops (word() selects one), so
// a mask stays in registers.
struct Mask {
  uint32_t w[MASK_WORDS];
  __device__ __forceinline__ uint32_t word(int c) const {
    uint32_t x = 0u;
#pragma unroll
    for (int k = 0; k < MASK_WORDS; ++k) x = k == c ? w[k] : x;
    return x;
  }
  __device__ __forceinline__ bool get(int v) const { return (word(v >> 5) >> (v & 31)) & 1u; }
  __device__ __forceinline__ void set(int v) {
#pragma unroll
    for (int k = 0; k < MASK_WORDS; ++k) w[k] |= k == (v >> 5) ? 1u << (v & 31) : 0u;
  }
  __device__ __forceinline__ int count() const {
    int n = 0;
#pragma unroll
    for (int k = 0; k < MASK_WORDS; ++k) n += __popc(w[k]);
    return n;
  }
};

struct Row {
  const int* img;     // (V,)
  const float* xy;    // (V, 2)
  const float* P;     // (C, 3, 4)
  const float* R;     // (C, 3, 3)
  const float* t;     // (C, 3)
  const float* intr;  // fx fy cx cy
  int V, C;
  __device__ int cam(int v) const { return min(max(img[v], 0), C - 1); }
};

__device__ __forceinline__ void view_rows(const Row& r, int v, float q[2][4]) {
  sfm_dlt_rows(r.P + (size_t)r.cam(v) * 12, r.xy[2 * v], r.xy[2 * v + 1], q);
}

// Reprojection error and depth of X in view v.
__device__ __forceinline__ float view_err(const Row& r, int v, const float X[3],
                                          float* depth) {
  const int c = r.cam(v);
  float u, w;
  *depth = sfm_project(r.R + (size_t)c * 9, r.t + (size_t)c * 3, r.intr, X[0], X[1], X[2],
                       &u, &w);
  const float du = u - r.xy[2 * v], dv = w - r.xy[2 * v + 1];
  return sqrtf(du * du + dv * dv);
}

// X from the views in `use`: every lane takes its views' DLT rows, and every
// lane sums the 4x4 matrix alike, view by view in view order.
__device__ __forceinline__ void dlt_views(const Row& r, const Mask& use, int lane, float X[3]) {
  float A[4][4] = {{0.f}};
#pragma unroll
  for (int c = 0; c < MASK_WORDS; ++c) {
    if (use.w[c] == 0u) continue;
    float q[2][4] = {{0.f}};
    if ((use.w[c] >> lane) & 1u) view_rows(r, c * 32 + lane, q);
    for (uint32_t m = use.w[c]; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      float qv[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) qv[k][j] = __shfl_sync(FULL, q[k][j], src);
      sfm_dlt_accumulate(qv, A);
    }
  }
  sfm_solve_dlt(A, X);
}

// The inliers of X among the views in `use` (in front, error <= max_err), as
// a mask; every lane gets it.
__device__ __forceinline__ Mask inliers(const Row& r, const Mask& use, const float X[3],
                                        float max_err, int lane) {
  Mask out;
#pragma unroll
  for (int c = 0; c < MASK_WORDS; ++c) {
    out.w[c] = 0u;
    if (use.w[c] == 0u) continue;
    bool in = false;
    if ((use.w[c] >> lane) & 1u) {
      float d;
      const float e = view_err(r, c * 32 + lane, X, &d);
      in = d > 0.f && e <= max_err;
    }
    out.w[c] = __ballot_sync(FULL, in);
  }
  return out;
}

// The j-th slot of the row ordered usable-first (a stable argsort of ~use).
__device__ __forceinline__ int ordered_slot(const Mask& use, int V, int n_use, int j) {
  const bool want = j < n_use;
  int k = want ? j : j - n_use, slot = 0;
  bool found = false;
#pragma unroll
  for (int c = 0; c < MASK_WORDS; ++c) {
    const int left = V - c * 32;
    if (found || left <= 0) continue;
    uint32_t m = want ? use.w[c] : ~use.w[c];
    if (left < 32) m &= (1u << left) - 1u;
    const int cnt = __popc(m);
    if (k >= cnt) {
      k -= cnt;
      continue;
    }
    for (; k > 0; --k) m &= m - 1;
    slot = c * 32 + __ffs(m) - 1;
    found = true;
  }
  return slot;
}

__global__ void __launch_bounds__(NT) triangulate_kernel(
    const int* __restrict__ view_img, const float* __restrict__ view_xy,
    const uint8_t* __restrict__ use_in, const uint8_t* __restrict__ active,
    const float* __restrict__ P_all, const float* __restrict__ Rs,
    const float* __restrict__ tvec, const float* __restrict__ centers,
    const float* __restrict__ intr, int T, int V, int C, float max_err,
    float min_parallax_deg, int robust_rounds, int seed_pairs_on, int n_seed,
    float* __restrict__ pts, uint8_t* __restrict__ ok_out) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= T) return;  // a whole warp
  const Row r{view_img + (size_t)row * V, view_xy + (size_t)row * V * 2, P_all, Rs, tvec,
              intr, V, C};
  Mask use;
#pragma unroll
  for (int c = 0; c < MASK_WORDS; ++c) {
    const int v = c * 32 + lane;
    use.w[c] = c * 32 < V ? __ballot_sync(FULL, v < V && use_in[(size_t)row * V + v] != 0) : 0u;
  }

  float X[3];
  dlt_views(r, use, lane, X);
  if (robust_rounds > 0 && seed_pairs_on && n_seed >= 2) {
    const int n_all = inliers(r, use, X, max_err, lane).count();
    const int n_use0 = use.count();
    // Lane k holds the k-th seed view.
    const int j = min(max((lane * max(n_use0, 1)) / n_seed, 0), V - 1);
    const int stride = lane < n_seed ? ordered_slot(use, V, n_use0, j) : 0;
    // The point of hypothesis h = (a, b), a < b, numbered in the serial
    // loop's order; every lane calls it (the views come by shuffle).
    auto hypothesis = [&](int h, float Xp[3]) {
      int a = 0, rem = h;
      while (rem >= n_seed - 1 - a) {
        rem -= n_seed - 1 - a;
        ++a;
      }
      const int va = __shfl_sync(FULL, stride, a), vb = __shfl_sync(FULL, stride, a + 1 + rem);
      float A[4][4] = {{0.f}}, q[2][4];
      view_rows(r, va, q);
      sfm_dlt_accumulate(q, A);
      view_rows(r, vb, q);
      sfm_dlt_accumulate(q, A);
      sfm_solve_dlt(A, Xp);
    };
    // A lane a hypothesis: its inliers over the usable views.
    const int H = n_seed * (n_seed - 1) / 2;
    int best_score = -1, best_h = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int h = h0 + lane;
      float Xp[3];
      hypothesis(min(h, H - 1), Xp);
      if (h >= H) continue;
      int s = 0;
#pragma unroll
      for (int c = 0; c < MASK_WORDS; ++c)
        for (uint32_t m = use.w[c]; m; m &= m - 1) {
          float d;
          const float e = view_err(r, c * 32 + __ffs(m) - 1, Xp, &d);
          if (d > 0.f && e <= max_err) ++s;
        }
      if (s > best_score) {
        best_score = s;
        best_h = h;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int os = __shfl_xor_sync(FULL, best_score, off);
      const int oh = __shfl_xor_sync(FULL, best_h, off);
      if (os > best_score || (os == best_score && oh < best_h)) {
        best_score = os;
        best_h = oh;
      }
    }
    if (best_score > n_all && best_score >= 3) {
      float Xp[3];
      hypothesis(best_h, Xp);
      use = inliers(r, use, Xp, max_err, lane);
    }
    dlt_views(r, use, lane, X);
  }
  for (int round = 0; round < robust_rounds; ++round) {
    const Mask keep = inliers(r, use, X, max_err, lane);
    if (keep.count() >= 2) use = keep;
    dlt_views(r, use, lane, X);
  }
  const int n_use = use.count();
  const Mask good = inliers(r, use, X, max_err, lane);
  bool ok = good.count() == n_use && n_use >= 2;
  if (ok && min_parallax_deg > 0.f) {
    // min over used pairs v < w of the cosine between their rays: lane l
    // takes view v = 32 cv + l against each used w of chunk cw >= cv in turn.
    float min_cos = 1.f;
    for (int cw = 0; cw < (V + 31) / 32; ++cw) {
      float rw[3] = {0.f, 0.f, 0.f}, nw = 1.f;
      const int w_own = cw * 32 + lane;
      if (w_own < V && use.get(w_own)) {
        const float* c = centers + (size_t)r.cam(w_own) * 3;
        rw[0] = X[0] - c[0];
        rw[1] = X[1] - c[1];
        rw[2] = X[2] - c[2];
        nw = fmaxf(sqrtf(rw[0] * rw[0] + rw[1] * rw[1] + rw[2] * rw[2]), 1e-12f);
      }
      for (int cv = 0; cv <= cw; ++cv) {
        const int v = cv * 32 + lane;
        const bool mine = v < V && use.get(v);
        float rv[3] = {0.f, 0.f, 0.f}, nv = 1.f;
        if (mine) {
          const float* c = centers + (size_t)r.cam(v) * 3;
          rv[0] = X[0] - c[0];
          rv[1] = X[1] - c[1];
          rv[2] = X[2] - c[2];
          nv = fmaxf(sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]), 1e-12f);
        }
        for (uint32_t m = use.word(cw); m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const float w0 = __shfl_sync(FULL, rw[0], src), w1 = __shfl_sync(FULL, rw[1], src);
          const float w2 = __shfl_sync(FULL, rw[2], src), wn = __shfl_sync(FULL, nw, src);
          if (mine && v < cw * 32 + src)
            min_cos = fminf(min_cos, (rv[0] * w0 + rv[1] * w1 + rv[2] * w2) / (nv * wn));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      min_cos = fminf(min_cos, __shfl_xor_sync(FULL, min_cos, off));
    const float ang = acosf(fminf(fmaxf(min_cos, -1.f), 1.f)) * (180.f / 3.14159265358979f);
    ok = ang >= min_parallax_deg;
  }
  if (lane == 0) {
    pts[(size_t)row * 3] = X[0];
    pts[(size_t)row * 3 + 1] = X[1];
    pts[(size_t)row * 3 + 2] = X[2];
    ok_out[row] = ok && active[row];
  }
}

// ---- A thread a row (layout 1): the first design, with the same expressions.

// Adds view v's two DLT rows to A.
__device__ __forceinline__ void add_view(const Row& r, int v, float A[4][4]) {
  sfm_dlt_add(r.P + (size_t)r.cam(v) * 12, r.xy[2 * v], r.xy[2 * v + 1], A);
}

// X from the views in `use`, summed view by view in view order.
__device__ void dlt_row(const Row& r, const Mask& use, float X[3]) {
  float A[4][4] = {{0.f}};
  for (int v = 0; v < r.V; ++v)
    if (use.get(v)) add_view(r, v, A);
  sfm_solve_dlt(A, X);
}

// The inliers of X among the views in `use`, counted and (with `out`) kept.
__device__ int row_inliers(const Row& r, const Mask& use, const float X[3], float max_err,
                           Mask* out) {
  int n = 0;
  if (out)
#pragma unroll
    for (int k = 0; k < MASK_WORDS; ++k) out->w[k] = 0u;
  for (int v = 0; v < r.V; ++v) {
    if (!use.get(v)) continue;
    float d;
    const float e = view_err(r, v, X, &d);
    if (d > 0.f && e <= max_err) {
      ++n;
      if (out) out->set(v);
    }
  }
  return n;
}

__global__ void __launch_bounds__(NT) triangulate_row_kernel(
    const int* __restrict__ view_img, const float* __restrict__ view_xy,
    const uint8_t* __restrict__ use_in, const uint8_t* __restrict__ active,
    const float* __restrict__ P_all, const float* __restrict__ Rs,
    const float* __restrict__ tvec, const float* __restrict__ centers,
    const float* __restrict__ intr, int T, int V, int C, float max_err,
    float min_parallax_deg, int robust_rounds, int seed_pairs_on, int n_seed,
    float* __restrict__ pts, uint8_t* __restrict__ ok_out) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= T) return;
  const Row r{view_img + (size_t)row * V, view_xy + (size_t)row * V * 2, P_all, Rs, tvec,
              intr, V, C};
  Mask use;
#pragma unroll
  for (int k = 0; k < MASK_WORDS; ++k) use.w[k] = 0u;
  for (int v = 0; v < V; ++v)
    if (use_in[(size_t)row * V + v] != 0) use.set(v);

  float X[3];
  dlt_row(r, use, X);
  if (robust_rounds > 0 && seed_pairs_on && n_seed >= 2) {
    const int n_all = row_inliers(r, use, X, max_err, nullptr);
    const int n_use0 = use.count();
    int best_score = -1, best_a = 0, best_b = 0;
    for (int a = 0; a < n_seed; ++a) {
      const int va = ordered_slot(use, V, n_use0, min(max((a * max(n_use0, 1)) / n_seed, 0),
                                                      V - 1));
      for (int b = a + 1; b < n_seed; ++b) {
        const int vb = ordered_slot(use, V, n_use0, min(max((b * max(n_use0, 1)) / n_seed, 0),
                                                        V - 1));
        float A[4][4] = {{0.f}}, Xp[3];
        add_view(r, va, A);
        add_view(r, vb, A);
        sfm_solve_dlt(A, Xp);
        const int s = row_inliers(r, use, Xp, max_err, nullptr);
        if (s > best_score) {
          best_score = s;
          best_a = va;
          best_b = vb;
        }
      }
    }
    if (best_score > n_all && best_score >= 3) {
      float A[4][4] = {{0.f}}, Xp[3];
      add_view(r, best_a, A);
      add_view(r, best_b, A);
      sfm_solve_dlt(A, Xp);
      Mask m;
      row_inliers(r, use, Xp, max_err, &m);
      use = m;
    }
    dlt_row(r, use, X);
  }
  for (int round = 0; round < robust_rounds; ++round) {
    Mask keep;
    if (row_inliers(r, use, X, max_err, &keep) >= 2) use = keep;
    dlt_row(r, use, X);
  }
  const int n_use = use.count();
  bool ok = row_inliers(r, use, X, max_err, nullptr) == n_use && n_use >= 2;
  if (ok && min_parallax_deg > 0.f) {
    float min_cos = 1.f;
    for (int v = 0; v < V; ++v) {
      if (!use.get(v)) continue;
      const float* cv = centers + (size_t)r.cam(v) * 3;
      const float rv[3] = {X[0] - cv[0], X[1] - cv[1], X[2] - cv[2]};
      const float nv = fmaxf(sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]), 1e-12f);
      for (int w = v + 1; w < V; ++w) {
        if (!use.get(w)) continue;
        const float* cw = centers + (size_t)r.cam(w) * 3;
        const float rw[3] = {X[0] - cw[0], X[1] - cw[1], X[2] - cw[2]};
        const float nw = fmaxf(sqrtf(rw[0] * rw[0] + rw[1] * rw[1] + rw[2] * rw[2]), 1e-12f);
        min_cos = fminf(min_cos, (rv[0] * rw[0] + rv[1] * rw[1] + rv[2] * rw[2]) / (nv * nw));
      }
    }
    const float ang = acosf(fminf(fmaxf(min_cos, -1.f), 1.f)) * (180.f / 3.14159265358979f);
    ok = ang >= min_parallax_deg;
  }
  pts[(size_t)row * 3] = X[0];
  pts[(size_t)row * 3 + 1] = X[1];
  pts[(size_t)row * 3 + 2] = X[2];
  ok_out[row] = ok && active[row];
}

__global__ void __launch_bounds__(NT) reproj_kernel(
    const int* __restrict__ view_img, const float* __restrict__ view_xy,
    const uint8_t* __restrict__ view_valid, const uint8_t* __restrict__ registered,
    const float* __restrict__ Rs, const float* __restrict__ tvec,
    const float* __restrict__ intr, const float* __restrict__ points,
    const uint8_t* __restrict__ point_valid, int T, int V, int C,
    float* __restrict__ err, uint8_t* __restrict__ use_out) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= (size_t)T * V) return;
  const size_t t = i / V;
  const int c = min(max(view_img[i], 0), C - 1);
  const bool use = view_valid[i] && registered[c] && point_valid[t];
  float u, v;
  sfm_project(Rs + (size_t)c * 9, tvec + (size_t)c * 3, intr, points[3 * t],
              points[3 * t + 1], points[3 * t + 2], &u, &v);
  const float du = u - view_xy[2 * i], dv = v - view_xy[2 * i + 1];
  err[i] = use ? sqrtf(du * du + dv * dv) : 0.f;
  use_out[i] = use;
}

}  // namespace

SFM_API int sfm_triangulate_tracks(const void* view_img, const void* view_xy,
                                   const void* use, const void* active, const void* P_all,
                                   const void* Rs, const void* tvec, const void* centers,
                                   const void* intr, int T, int V, int C, float max_err,
                                   float min_parallax_deg, int robust_rounds,
                                   int seed_pairs_on, int n_seed, int layout, void* pts,
                                   void* ok, void* stream) {
  if (V > 32 * MASK_WORDS || (seed_pairs_on && n_seed > MAX_SEED) || layout < 0 || layout > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    // Layout 0: a warp a row; 1: a thread a row.
    const int rows = layout ? NT : ROWS;
    (layout ? triangulate_row_kernel : triangulate_kernel)<<<
        (T + rows - 1) / rows, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(view_img), static_cast<const float*>(view_xy),
        static_cast<const uint8_t*>(use), static_cast<const uint8_t*>(active),
        static_cast<const float*>(P_all), static_cast<const float*>(Rs),
        static_cast<const float*>(tvec), static_cast<const float*>(centers),
        static_cast<const float*>(intr), T, V, C, max_err, min_parallax_deg, robust_rounds,
        seed_pairs_on, n_seed, static_cast<float*>(pts), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_reproj_stats(const void* view_img, const void* view_xy,
                             const void* view_valid, const void* registered, const void* Rs,
                             const void* tvec, const void* intr, const void* points,
                             const void* point_valid, int T, int V, int C, void* err,
                             void* use, void* stream) {
  const size_t n = (size_t)T * V;
  if (n > 0) {
    reproj_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(view_img), static_cast<const float*>(view_xy),
        static_cast<const uint8_t*>(view_valid), static_cast<const uint8_t*>(registered),
        static_cast<const float*>(Rs), static_cast<const float*>(tvec),
        static_cast<const float*>(intr), static_cast<const float*>(points),
        static_cast<const uint8_t*>(point_valid), T, V, C, static_cast<float*>(err),
        static_cast<uint8_t*>(use));
  }
  return static_cast<int>(cudaGetLastError());
}
