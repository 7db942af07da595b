// Kernel K7: robust multi-view triangulation of track rows, and the per-slot
// reprojection error (two entries).
//
// Replaces sfm_tpu/reconstruction/incremental.py::_triangulate_tracks (:48,
// the vmapped `one` of :83-152) and _reproj_stats (:183). There each track's
// V views, 28 seed-pair hypotheses and drop-and-resolve rounds are vmapped
// tensor programs with (T, 28, V) intermediates in device memory; here one
// thread does a whole track row in registers:
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
// What bounds it on the H100: f32 arithmetic per row (a 36-view row with seed
// pairs: ~30 DLT solves and ~1,100 projections, ~60k FLOP); 2048 rows are
// 16 blocks of 128 threads, so a bucket fills only a few SMs and takes the
// latency of its longest row. The host keeps the bucket/chunk logic.
#include "sfm_common.cuh"

namespace {

constexpr int NT = 128;
constexpr int MASK_WORDS = 8;  // V <= 256
constexpr int MAX_SEED = 32;   // n_seed <= 32 when seed pairs are on

struct Mask {
  uint32_t w[MASK_WORDS];
  __device__ bool get(int v) const { return (w[v >> 5] >> (v & 31)) & 1u; }
  __device__ void set(int v, bool b) {
    if (b) w[v >> 5] |= 1u << (v & 31);
    else w[v >> 5] &= ~(1u << (v & 31));
  }
  __device__ int count(int V) const {
    int n = 0;
    for (int k = 0; k < (V + 31) / 32; ++k) n += __popc(w[k]);
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

// Adds the two normalized DLT rows of view v to AtA.
__device__ __forceinline__ void add_rows(const Row& r, int v, float A[4][4]) {
  sfm_dlt_add(r.P + (size_t)r.cam(v) * 12, r.xy[2 * v], r.xy[2 * v + 1], A);
}

__device__ void dlt_views(const Row& r, const Mask& use, float X[3]) {
  float A[4][4] = {{0.f}};
  for (int v = 0; v < r.V; ++v)
    if (use.get(v)) add_rows(r, v, A);
  sfm_solve_dlt(A, X);
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

// Inliers of X among the views in `use` (written to `out` when not null).
__device__ int inliers(const Row& r, const Mask& use, const float X[3], float max_err,
                       Mask* out) {
  int n = 0;
  if (out)
    for (int k = 0; k < MASK_WORDS; ++k) out->w[k] = 0u;
  for (int v = 0; v < r.V; ++v) {
    if (!use.get(v)) continue;
    float d;
    const float e = view_err(r, v, X, &d);
    if (d > 0.f && e <= max_err) {
      ++n;
      if (out) out->set(v, true);
    }
  }
  return n;
}

// The j-th slot of the row ordered usable-first (a stable argsort of ~use).
__device__ int ordered_slot(const Mask& use, int V, int n_use, int j) {
  const bool want = j < n_use;
  int k = want ? j : j - n_use;
  for (int v = 0; v < V; ++v)
    if (use.get(v) == want && k-- == 0) return v;
  return 0;
}

__global__ void __launch_bounds__(NT) triangulate_kernel(
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
  for (int k = 0; k < MASK_WORDS; ++k) use.w[k] = 0u;
  for (int v = 0; v < V; ++v) use.set(v, use_in[(size_t)row * V + v] != 0);

  float X[3];
  dlt_views(r, use, X);
  if (robust_rounds > 0 && seed_pairs_on && n_seed >= 2) {
    const int n_all = inliers(r, use, X, max_err, nullptr);
    const int n_use0 = use.count(V);
    int stride[MAX_SEED];
    for (int k = 0; k < n_seed; ++k) {
      const int j = min(max((k * max(n_use0, 1)) / n_seed, 0), V - 1);
      stride[k] = ordered_slot(use, V, n_use0, j);
    }
    int best_score = -1, best_a = 0, best_b = 0;
    for (int a = 0; a < n_seed; ++a)
      for (int b = a + 1; b < n_seed; ++b) {
        float A[4][4] = {{0.f}}, Xp[3];
        add_rows(r, stride[a], A);
        add_rows(r, stride[b], A);
        sfm_solve_dlt(A, Xp);
        const int s = inliers(r, use, Xp, max_err, nullptr);
        if (s > best_score) {
          best_score = s;
          best_a = stride[a];
          best_b = stride[b];
        }
      }
    if (best_score > n_all && best_score >= 3) {
      float A[4][4] = {{0.f}}, Xp[3];
      add_rows(r, best_a, A);
      add_rows(r, best_b, A);
      sfm_solve_dlt(A, Xp);
      Mask m;
      inliers(r, use, Xp, max_err, &m);
      use = m;
    }
    dlt_views(r, use, X);
  }
  for (int round = 0; round < robust_rounds; ++round) {
    Mask keep;
    const int n_keep = inliers(r, use, X, max_err, &keep);
    if (n_keep >= 2) use = keep;
    dlt_views(r, use, X);
  }
  int n_use = 0;
  bool ok = true;
  for (int v = 0; v < V; ++v) {
    if (!use.get(v)) continue;
    ++n_use;
    float d;
    const float e = view_err(r, v, X, &d);
    ok = ok && d > 0.f && e <= max_err;
  }
  ok = ok && n_use >= 2;
  if (ok && min_parallax_deg > 0.f) {
    float min_cos = 1.f;
    for (int v = 0; v < V; ++v) {
      if (!use.get(v)) continue;
      const float* cv = centers + (size_t)r.cam(v) * 3;
      float rv[3] = {X[0] - cv[0], X[1] - cv[1], X[2] - cv[2]};
      const float nv = fmaxf(sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]), 1e-12f);
      for (int w = v + 1; w < V; ++w) {
        if (!use.get(w)) continue;
        const float* cw = centers + (size_t)r.cam(w) * 3;
        float rw[3] = {X[0] - cw[0], X[1] - cw[1], X[2] - cw[2]};
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
                                   int seed_pairs_on, int n_seed, void* pts, void* ok,
                                   void* stream) {
  if (V > 32 * MASK_WORDS || (seed_pairs_on && n_seed > MAX_SEED))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    triangulate_kernel<<<(T + NT - 1) / NT, NT, 0, static_cast<cudaStream_t>(stream)>>>(
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
