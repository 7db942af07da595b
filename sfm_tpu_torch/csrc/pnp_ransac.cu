// Kernel K6: P3P-RANSAC for a batch of PnP candidates, one launch a round.
//
// Replaces sfm_tpu/estimators/pnp.py::pnp_ransac_batch / pnp_ransac on the P3P
// path (sample_size 3): the vmapped _p3p_candidates (:114, Durand-Kerner quartic
// :94), then the (B, hypotheses, N) projection-error matrix with cheirality and
// ransac_select. There the error matrix (8192 x 2048 f32 = 64 MB per candidate)
// goes through device memory; here each hypothesis's count and error sum stay on
// the chip.
//
// Entries. sfm_p3p_ransac: the round from the drawn sample indices on -- each
// sample's Grunert P3P (the 4 poses written for every hypothesis), the
// scoring of every hypothesis over the candidate's rows, and ransac_select's
// winner (the highest score, then the lowest index). sfm_pnp_score_select: the
// same scoring and winner for hypotheses given (the DLT branch's).
// sfm_p3p_solve: the poses alone, from samples gathered by the caller.
//
// What bounds it on the H100: issue slots. Per (hypothesis, valid row) the
// projection and its error are ~25 f32 operations (8 x 8,192 x ~1,200 of them
// a phase round); the inputs are ~50 KB a candidate. The first design (one
// thread a (candidate, sample) through 4 roots, one thread a hypothesis over
// every padded row with two IEEE divisions and a square root a row, a third
// launch for the winner) ran long dependent chains on a third of the card.
//
// Design: a block of 256 threads is a tile of 256 hypotheses of one candidate
// (64 samples), grid (tiles, candidates).
// - Staging: the candidate's rows up to its last valid one, found while
//   staging, in shared memory as five arrays (X, Y, Z, u, v; an invalid row's X
//   is NaN, so it never counts).
// - Solve: 4 lanes a sample, lane k owns root k through the 30 Durand-Kerner
//   steps (the other roots by __shfl_sync, the first design's expressions in
//   its order), then builds root k's pose and writes it (t rounded as the
//   first design's compiled code rounds it for root k).
// - Walk: warp w owns the tile's hypotheses 32w..32w+31. For each step of 32
//   rows (lane l holds row 32s + l in registers) it takes its 32 hypotheses in
//   turn: each lane projects its row; an exact pre-test rejects, without the
//   two divisions and the square root, a row that provably cannot count
//   (depth <= 0, or |fx x + (cx - u) z| > thr' z + kap |fx x| for u or for v,
//   thr' and kap from the wrapper: the margin covers every rounding of the
//   exact path, fused or not, and a NaN goes to the exact path); where any
//   lane cannot reject, the warp takes the first design's exact expressions.
//   Each lane writes its error (-0.f when the row does not count) to the
//   warp's 32 x 32 tile; then lane j adds hypothesis j's 32 errors in row
//   order to its running sum (adding -0.f changes no sum) and counts the
//   non-negative ones. So each sum is the first design's sequence of float
//   adds, and every score keeps its bits.
// - Winner: each tile's best to device memory, a ticket finds the candidate's
//   last tile, which picks the winner over the tiles' bests (a total order,
//   so any order of tiles) and leaves the ticket at 0 for the next launch.
#include <climits>

#include "sfm_common.cuh"

#ifndef SFM_ST
#define SFM_ST_INIT(idx, on)
#define SFM_ST(slot)
#define SFM_ST_END
#endif

namespace {

constexpr int NT = 256;         // threads a block
constexpr int HT = 256;         // hypotheses a block (a thread each)
constexpr int SB = HT / 4;      // P3P samples a block
constexpr int TP = 33;          // row pitch of a warp's 32 x 32 error tile
constexpr float kEps = 1e-12f;

struct cf {
  float x, y;
};
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ cf cdiv(cf a, cf b) {  // Smith's algorithm
  if (fabsf(b.x) >= fabsf(b.y)) {
    const float r = b.y / b.x, d = b.x + b.y * r;
    return {(a.x + a.y * r) / d, (a.y - a.x * r) / d};
  }
  const float r = b.x / b.y, d = b.y + b.x * r;
  return {(a.x * r + a.y) / d, (a.y * r - a.x) / d};
}
__device__ __forceinline__ float cabs_(cf a) { return hypotf(a.x, a.y); }

__device__ __forceinline__ void normalize3(float* v) {
  const float n = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), kEps);
  v[0] /= n;
  v[1] /= n;
  v[2] /= n;
}

// Orthonormal frame of 3 points Q (rows): T's columns are e1, e2, e3.
__device__ bool triad(const float Q[3][3], float T[3][3]) {
  float e1[3], e2[3], e3[3];
  for (int k = 0; k < 3; ++k) {
    e1[k] = Q[1][k] - Q[0][k];
    e2[k] = Q[2][k] - Q[0][k];
  }
  normalize3(e1);
  const float d = e2[0] * e1[0] + e2[1] * e1[1] + e2[2] * e1[2];
  for (int k = 0; k < 3; ++k) e2[k] -= d * e1[k];
  const float n2 = sqrtf(e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]);
  for (int k = 0; k < 3; ++k) e2[k] /= fmaxf(n2, kEps);
  e3[0] = e1[1] * e2[2] - e1[2] * e2[1];
  e3[1] = e1[2] * e2[0] - e1[0] * e2[2];
  e3[2] = e1[0] * e2[1] - e1[1] * e2[0];
  for (int k = 0; k < 3; ++k) {
    T[k][0] = e1[k];
    T[k][1] = e2[k];
    T[k][2] = e3[k];
  }
  return n2 > 1e-9f;
}

// Grunert's P3P for one sample (P: world points, rows; s2: normalized image
// coordinates), root k of the quartic: its pose (I, 0 when masked) and ok.
// The 4 lanes of an aligned quad hold one sample's roots k = 0..3 and must
// all call it (full-warp shuffles).
__device__ bool p3p_root(const float P[3][3], const float s2[3][2], int k, float R[3][3],
                         float t[3]) {
  float f[3][3];
  for (int r = 0; r < 3; ++r) {
    f[r][0] = s2[r][0];
    f[r][1] = s2[r][1];
    f[r][2] = 1.f;
    normalize3(f[r]);
  }
  auto sq = [](const float* a, const float* b) {
    const float x = a[0] - b[0], y = a[1] - b[1], z = a[2] - b[2];
    return x * x + y * y + z * z;
  };
  auto dot = [](const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  };
  const float a2 = sq(P[1], P[2]);
  const float b2 = fmaxf(sq(P[0], P[2]), kEps);
  const float c2 = sq(P[0], P[1]);
  const float cos_a = dot(f[1], f[2]), cos_b = dot(f[0], f[2]), cos_c = dot(f[0], f[1]);
  const float q = (a2 - c2) / b2;
  const float A4 = (q - 1.f) * (q - 1.f) - 4.f * c2 / b2 * cos_a * cos_a;
  const float A3 = 4.f * (q * (1.f - q) * cos_b - (1.f - (a2 + c2) / b2) * cos_a * cos_c +
                          2.f * c2 / b2 * cos_a * cos_a * cos_b);
  const float A2 = 2.f * (q * q - 1.f + 2.f * q * q * cos_b * cos_b +
                          2.f * (b2 - c2) / b2 * cos_a * cos_a -
                          4.f * (a2 + c2) / b2 * cos_a * cos_b * cos_c +
                          2.f * (b2 - a2) / b2 * cos_c * cos_c);
  const float A1 = 4.f * (-q * (1.f + q) * cos_b + 2.f * a2 / b2 * cos_c * cos_c * cos_b -
                          (1.f - (a2 + c2) / b2) * cos_a * cos_c);
  const float A0 = (1.f + q) * (1.f + q) - 4.f * a2 / b2 * cos_c * cos_c;

  // Durand-Kerner on the monic quartic, root k in this lane.
  const float scale = fabsf(A4) > 1e-12f ? A4 : (A4 >= 0.f ? 1e-12f : -1e-12f);
  const cf a3{A3 / scale, 0.f}, a2c{A2 / scale, 0.f}, a1{A1 / scale, 0.f},
      a0{A0 / scale, 0.f};
  const float rad = powf(1.f + fabsf(a0.x), 0.25f);
  cf zk = k == 0   ? cf{rad, 0.f}
          : k == 1 ? cf{0.4f * rad, 0.9f * rad}
          : k == 2 ? cf{-0.65f * rad, 0.72f * rad}
                   : cf{-0.908f * rad, -0.297f * rad};
  for (int it = 0; it < 30; ++it) {
    cf z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      z[j] = cf{__shfl_sync(0xffffffffu, zk.x, j, 4), __shfl_sync(0xffffffffu, zk.y, j, 4)};
    cf den{1.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const cf d = j == k ? cf{1.f, 0.f} : csub(zk, z[j]);
      den = cmul(den, d);
    }
    const cf p = cadd(cmul(cadd(cmul(cadd(cmul(cadd(zk, a3), zk), a2c), zk), a1), zk), a0);
    if (!(cabs_(den) > 1e-20f)) den = cf{1e-20f, 0.f};
    zk = csub(zk, cdiv(p, den));
  }

  float Tw[3][3];
  const bool w_ok = triad(P, Tw);
  const float v = zk.x;
  bool ok = fabsf(zk.y) < 1e-4f * (1.f + fabsf(v)) && v > kEps;
  const float num = (-1.f + q) * v * v - 2.f * q * cos_b * v + 1.f + q;
  const float den = 2.f * (cos_c - v * cos_a);
  const float u = num / (fabsf(den) > 1e-9f ? den : 1e-9f);
  const float s = 1.f + v * v - 2.f * v * cos_b;
  ok = ok && u > kEps && s > kEps && fabsf(den) > 1e-9f;
  const float d1 = sqrtf(b2 / fmaxf(s, kEps));
  float Pc[3][3];
  for (int c = 0; c < 3; ++c) {
    Pc[0][c] = d1 * f[0][c];
    Pc[1][c] = (u * d1) * f[1][c];
    Pc[2][c] = (v * d1) * f[2][c];
  }
  float Tc[3][3], Rr[3][3], tr[3];
  const bool c_ok = triad(Pc, Tc);
  bool finite = true;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      Rr[r][c] = Tc[r][0] * Tw[c][0] + Tc[r][1] * Tw[c][1] + Tc[r][2] * Tw[c][2];
      finite = finite && isfinite(Rr[r][c]);
    }
  for (int r = 0; r < 3; ++r) {
    // Pc[0][r] - R[r] . P[0], rounded as the first design's compiled code
    // rounds it: the product sums as fma(R2, P2, fma(R0, P0, R1 P1)), and
    // d1 f[0][r] - sum in one fma for roots 0-2 but a rounded product for
    // root 3 (its Pc[0][r] had other uses there).
    const float sum = __fmaf_rn(Rr[r][2], P[0][2], __fmaf_rn(Rr[r][0], P[0][0],
                                                             __fmul_rn(Rr[r][1], P[0][1])));
    tr[r] = k < 3 ? __fmaf_rn(d1, f[0][r], -sum) : __fsub_rn(Pc[0][r], sum);
    finite = finite && isfinite(tr[r]);
  }
  ok = ok && c_ok && w_ok && finite;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) R[r][c] = ok ? Rr[r][c] : (r == c ? 1.f : 0.f);
    t[r] = ok ? tr[r] : 0.f;
  }
  return ok;
}

__device__ __forceinline__ void store_pose(const float R[3][3], const float t[3], bool ok,
                                           size_t gh, float* __restrict__ Rs,
                                           float* __restrict__ ts, uint8_t* __restrict__ ok_out) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) Rs[gh * 9 + r * 3 + c] = R[r][c];
    ts[gh * 3 + r] = t[r];
  }
  ok_out[gh] = ok;
}

// The solve alone: 4 threads a gathered sample (s3 (n, 3, 3), s2n (n, 3, 2)).
__global__ void __launch_bounds__(NT) p3p_solve_kernel(const float* __restrict__ s3,
                                                       const float* __restrict__ s2n, int n,
                                                       float* __restrict__ Rs,
                                                       float* __restrict__ ts,
                                                       uint8_t* __restrict__ ok_out) {
  const int i = blockIdx.x * SB + threadIdx.x / 4, k = threadIdx.x % 4;
  const int ic = i < n ? i : n - 1;   // a quad past the end computes and drops the last
  float P[3][3], s2[3][2];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) P[r][c] = s3[(size_t)ic * 9 + r * 3 + c];
    s2[r][0] = s2n[(size_t)ic * 6 + r * 2];
    s2[r][1] = s2n[(size_t)ic * 6 + r * 2 + 1];
  }
  float R[3][3], t[3];
  const bool ok = p3p_root(P, s2, k, R, t);
  if (i < n) store_pose(R, t, ok, (size_t)i * 4 + k, Rs, ts, ok_out);
}

struct RoundArgs {
  const int64_t* idx;     // (B, S, 3) sample rows (the P3P round)
  const float* pts3d;     // (B, N, 3)
  const float* pn;        // (B, N, 2) normalized image coordinates (the P3P round)
  const float* pts2d;     // (B, N, 2) pixels
  const uint8_t* valid;   // (B, N)
  const float* intr;      // fx, fy, cx, cy
  int S, H, N;
  float thr, thr_pre, kap;
  float* Rs;              // (B, H, 3, 3): written (P3P) or read (hypotheses given)
  float* ts;              // (B, H, 3)
  uint8_t* ok;            // (B, H)
  int* part;              // (B, tiles, 3): each tile's best (score bits, h, count)
  int* tickets;           // (>= B), zero between launches
  int* best;              // (B,)
  int* count;             // (B,)
};

// Shared memory: the tile's hypotheses (R, t in three float4 each), the warps'
// error tiles, then the candidate's rows (5 arrays of N).
constexpr size_t kHypFloats = (size_t)HT * 12;
constexpr size_t kTileFloats = (size_t)(NT / 32) * 32 * TP;
__host__ __device__ constexpr size_t round_smem_bytes(int N) {
  return (kHypFloats + kTileFloats + 5 * (size_t)N) * sizeof(float);
}

template <bool kSolve>
__global__ void __launch_bounds__(NT, 2) pnp_round_kernel(RoundArgs a) {
  extern __shared__ __align__(16) float sm[];
  float4* hp = reinterpret_cast<float4*>(sm);
  float* tiles = sm + kHypFloats;
  float* rows = tiles + kTileFloats;
  __shared__ unsigned s_okmask[NT / 32];
  __shared__ int s_last_row, s_last;
  const int tile = blockIdx.x, T = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = a.N, H = a.H;
  SFM_ST_INIT(b * T + tile, tid == 0)

  // Staging: the rows up to the last valid one.
  if (tid == 0) s_last_row = -1;
  __syncthreads();
  int last = -1;
  for (int n = tid; n < N; n += NT)
    if (a.valid[(size_t)b * N + n]) last = n;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&s_last_row, last);
  __syncthreads();
  const int nrows = s_last_row + 1;
  for (int n = tid; n < nrows; n += NT) {
    const size_t o = (size_t)b * N + n;
    rows[n] = a.valid[o] ? a.pts3d[3 * o] : __int_as_float(0x7fc00000);
    rows[N + n] = a.pts3d[3 * o + 1];
    rows[2 * N + n] = a.pts3d[3 * o + 2];
    rows[3 * N + n] = a.pts2d[2 * o];
    rows[4 * N + n] = a.pts2d[2 * o + 1];
  }
  SFM_ST(0)

  // The tile's hypotheses: solved here (thread = sample x 4 + root) or loaded.
  const int h = tile * HT + tid;
  float R[3][3], t[3];
  bool hok;
  if (kSolve) {
    const int g = tile * SB + tid / 4;
    const int gc = g < a.S ? g : a.S - 1;   // a quad past the end computes and drops the last
    float P[3][3], s2[3][2];
    for (int r = 0; r < 3; ++r) {
      const int64_t i = sfm_clamp_index(a.idx[((size_t)b * a.S + gc) * 3 + r], N - 1);
      const size_t o = (size_t)b * N + i;
      for (int c = 0; c < 3; ++c) P[r][c] = a.pts3d[3 * o + c];
      s2[r][0] = a.pn[2 * o];
      s2[r][1] = a.pn[2 * o + 1];
    }
    hok = p3p_root(P, s2, tid % 4, R, t);
    if (g < a.S) store_pose(R, t, hok, (size_t)b * H + h, a.Rs, a.ts, a.ok);
  } else {
    const size_t gh = (size_t)b * H + (h < H ? h : H - 1);
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) R[r][c] = a.Rs[gh * 9 + r * 3 + c];
      t[r] = a.ts[gh * 3 + r];
    }
    hok = a.ok[gh] != 0;
  }
  SFM_ST(3)
  hp[tid * 3] = make_float4(R[0][0], R[0][1], R[0][2], R[1][0]);
  hp[tid * 3 + 1] = make_float4(R[1][1], R[1][2], R[2][0], R[2][1]);
  hp[tid * 3 + 2] = make_float4(R[2][2], t[0], t[1], t[2]);
  const unsigned okm = __ballot_sync(0xffffffffu, hok && h < H);
  if (lane == 0) s_okmask[warp] = okm;
  __syncthreads();

  // The walk: lane = row of the step, a loop over the warp's 32 hypotheses;
  // then lane j adds hypothesis j's errors in row order.
  float k4[4];
  for (int k = 0; k < 4; ++k) k4[k] = a.intr[k];
  const float thr = a.thr, thr_pre = a.thr_pre, kap = a.kap;
  float* tw = tiles + warp * 32 * TP;
  const float4* hw = hp + warp * 32 * 3;
  float err_sum = 0.f;
  int count = 0;
  for (int r0 = 0; r0 < nrows; r0 += 32) {
    const int r = r0 + lane;
    float X = __int_as_float(0x7fc00000), Y = 0.f, Z = 0.f, uo = 0.f, vo = 0.f;
    if (r < nrows) {
      X = rows[r];
      Y = rows[N + r];
      Z = rows[2 * N + r];
      uo = rows[3 * N + r];
      vo = rows[4 * N + r];
    }
    const float cu = k4[2] - uo, cv = k4[3] - vo;
    const float Tu = fmaf(kap, fabsf(k4[2]) + fabsf(uo), thr_pre);
    const float Tv = fmaf(kap, fabsf(k4[3]) + fabsf(vo), thr_pre);
#pragma unroll 2
    for (int j = 0; j < 32; ++j) {
      float e = -0.f;
      if ((okm >> j) & 1u) {
        const float4 q0 = hw[j * 3], q1 = hw[j * 3 + 1], q2 = hw[j * 3 + 2];
        const float Rh[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
        const float th[3] = {q2.y, q2.z, q2.w};
        // sfm_project's camera coordinates and depth clamp.
        const float x = Rh[0] * X + Rh[1] * Y + Rh[2] * Z + th[0];
        const float y = Rh[3] * X + Rh[4] * Y + Rh[5] * Z + th[1];
        const float d = Rh[6] * X + Rh[7] * Y + Rh[8] * Z + th[2];
        const float z = fabsf(d) < 1e-12f ? 1e-12f : d;
        const float ax = k4[0] * x, ay = k4[1] * y;
        const bool need = d > 0.f && !(fabsf(fmaf(cu, z, ax)) > fmaf(kap, fabsf(ax), Tu * z)) &&
                          !(fabsf(fmaf(cv, z, ay)) > fmaf(kap, fabsf(ay), Tv * z));
        if (__any_sync(0xffffffffu, need)) {
          float u, v;
          const float depth = sfm_project(Rh, th, k4, X, Y, Z, &u, &v);
          const float du = u - uo, dv = v - vo;
          const float err = sqrtf(du * du + dv * dv);
          if (need && depth > 0.f && err < thr) e = err;
        }
      }
      tw[j * TP + lane] = e;
    }
    __syncwarp();
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const float e = tw[lane * TP + i];
      err_sum += e;
      count += __float_as_int(e) >= 0;
    }
    __syncwarp();
  }
  SFM_ST(4)

  SfmCand best{-INFINITY, INT_MAX, 0};
  if (h < H) best = SfmCand{sfm_ransac_score(count, err_sum, thr), h, count};
  best = sfm_block_best<NT>(best);

  // The candidate's last tile to finish picks the winner.
  int* part = a.part + (size_t)b * T * 3;
  if (tid == 0) {
    part[3 * tile] = __float_as_int(best.score);
    part[3 * tile + 1] = best.h;
    part[3 * tile + 2] = best.count;
    __threadfence();
    s_last = atomicAdd(a.tickets + b, 1) == T - 1;
  }
  __syncthreads();
  SFM_ST(5)
  if (!s_last) {
    SFM_ST_END
    return;
  }
  __threadfence();
  SfmCand w{-INFINITY, INT_MAX, 0};
  for (int k = tid; k < T; k += NT)
    w = sfm_cand_max(w, SfmCand{__int_as_float(__ldcg(part + 3 * k)), __ldcg(part + 3 * k + 1),
                                __ldcg(part + 3 * k + 2)});
  w = sfm_block_best<NT>(w);
  if (tid == 0) {
    a.best[b] = w.h == INT_MAX ? 0 : w.h;
    a.count[b] = w.count;
    a.tickets[b] = 0;
  }
  SFM_ST(6)
  SFM_ST_END
}

int launch_round(bool solve, const RoundArgs& a, int B, cudaStream_t st) {
  const int T = (a.H + HT - 1) / HT;
  if (B <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = round_smem_bytes(a.N);
  if (solve)
    pnp_round_kernel<true><<<dim3(T, B), NT, smem, st>>>(a);
  else
    pnp_round_kernel<false><<<dim3(T, B), NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rows' shared memory above 48 KB, up to _K6_MAX_POINTS (8,192) rows.
SFM_API int sfm_pnp_ransac_setup(void* stream) {
  (void)stream;
  const int smem = static_cast<int>(round_smem_bytes(8192));
  cudaError_t e = cudaFuncSetAttribute(pnp_round_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pnp_round_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  return static_cast<int>(e);
}

SFM_API int sfm_p3p_solve(const void* s3, const void* s2n, int n, void* Rs, void* ts,
                          void* ok, void* stream) {
  if (n > 0) {
    p3p_solve_kernel<<<(n + SB - 1) / SB, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s3), static_cast<const float*>(s2n), n,
        static_cast<float*>(Rs), static_cast<float*>(ts), static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_p3p_ransac(const void* idx, const void* pts3d, const void* pn,
                           const void* pts2d, const void* valid, const void* intr, int B, int S,
                           int N, float thr, float thr_pre, float kap, void* Rs, void* ts,
                           void* ok, void* part, void* tickets, void* best, void* count,
                           void* stream) {
  const RoundArgs a{static_cast<const int64_t*>(idx), static_cast<const float*>(pts3d),
                    static_cast<const float*>(pn), static_cast<const float*>(pts2d),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(intr),
                    S, 4 * S, N, thr, thr_pre, kap, static_cast<float*>(Rs),
                    static_cast<float*>(ts), static_cast<uint8_t*>(ok), static_cast<int*>(part),
                    static_cast<int*>(tickets), static_cast<int*>(best),
                    static_cast<int*>(count)};
  return launch_round(true, a, B, static_cast<cudaStream_t>(stream));
}

SFM_API int sfm_pnp_score_select(const void* Rs, const void* ts, const void* cand_ok,
                                 const void* pts3d, const void* pts2d, const void* valid,
                                 const void* intr, int B, int H, int N, float thr,
                                 float thr_pre, float kap, void* part, void* tickets,
                                 void* best, void* count, void* stream) {
  const RoundArgs a{nullptr, static_cast<const float*>(pts3d), nullptr,
                    static_cast<const float*>(pts2d), static_cast<const uint8_t*>(valid),
                    static_cast<const float*>(intr), 0, H, N, thr, thr_pre, kap,
                    const_cast<float*>(static_cast<const float*>(Rs)),
                    const_cast<float*>(static_cast<const float*>(ts)),
                    const_cast<uint8_t*>(static_cast<const uint8_t*>(cand_ok)),
                    static_cast<int*>(part), static_cast<int*>(tickets), static_cast<int*>(best),
                    static_cast<int*>(count)};
  return launch_round(false, a, B, static_cast<cudaStream_t>(stream));
}
