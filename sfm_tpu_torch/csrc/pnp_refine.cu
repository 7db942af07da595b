// Kernel K6, second half: the two Gauss-Newton refits of the RANSAC winner.
//
// Replaces sfm_tpu/estimators/pnp.py::pnp_ransac_batch from the winning
// hypothesis onward (:329-361): refine_pose_gn (:201, a fori_loop of _gn_step,
// jax.jacfwd of the weighted reprojection residual and a 6x6 solve) on the
// winner's consensus set, re-derived weights, a second refit, then the final
// errors, inliers, count, min_inliers gate and finite guard. There every step
// is a (2N, 6) Jacobian in device memory and a batched solve; here one launch
// does all 20 steps.
//
// The arithmetic is the first design's (one block of 256 threads a
// candidate): per step, every row's residual and Jacobian give 21 J^T J and 6
// J^T r terms; thread t summed the terms of rows t, t + 256, ... in that order,
// then the xor-shuffle tree of its warp and the 8 warps in order made the 27
// sums, and thread 0 solved (J^T J + 1e-6 I) delta = J^T r by a 6x6 Cholesky
// and stepped params -= delta, the additive step in (rvec, t) of the
// reference. The Jacobian is the exact derivative of the twin's function, as
// jacfwd computes it: d/d rvec goes through rodrigues (with its theta^2 < 1e-8
// Taylor branch), formed once per step (forward mode with 3 tangents); per
// row, x_cam's 6 tangents go through the same projection (a clamped depth has
// no derivative). rotation_to_rvec runs here too, with the reference's three
// regimes. The weights multiply the residual, so a zero-weight row adds
// nothing and all-zero weights give a zero step.
//
// Design. The first design ran a candidate on one SM (B <= 8: 8 of 132), and
// its stamps (tests/ransac_stamps.py) put ~6.8 of a step's ~9.7 us in the
// rows' terms, 8 rows a thread in series. Here a candidate is a cluster of
// CL = 8 blocks of 512 threads, and block c is the first design's warp c: it
// owns the rows of virtual threads 32 c .. 32 c + 31 (rows n with n % 256 in
// that range) and keeps them and their weights in shared memory for the
// three weight passes and the 20 steps. A lane pair forms one row, each lane
// one component's residual and Jacobian (the 26 IEEE divisions of a row,
// whose slow-path branches serialize them in one thread, split in two), then
// both the row's terms, each lane storing half; 16 warps form 8 rows a
// virtual thread at once. Each step keeps the first design's sums exactly:
// lane l of warp 0 (terms 0-13) and of warp 1 (terms 14-26) adds its
// virtual thread's terms in row order (the same adds, the zero-weight rows
// skipped), then the same xor tree; lanes 0-7 of each store its half of the
// block's 27 sums into the 8 blocks' shared memory (distributed shared
// memory). One barrier.cluster a step; then in every block lane m of warp 0
// adds sum m of the 8 blocks in block order, as the first design added its
// warps, and warp 0 solves (the same solve in every block, so no broadcast;
// the sums are double-buffered by step parity), its Cholesky column
// divisions spread over lanes, then forms the next step's rodrigues and
// derivatives once for the block. The expressions are the first design's,
// so every term and sum rounds as it did.
//
// What bounds it on the H100: nothing of the card's rates -- 20 steps x N rows
// x ~150 FLOP is 25 MFLOP for B = 8 x 2048 (< 1 us at the f32 peak), and the
// inputs are 20 bytes a row. A step's chain sets its time: a row's terms, the
// ordered adds and the tree, the cluster barrier, the 6x6 solve, rodrigues.
#include <cooperative_groups.h>

#include "sfm_geom.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;              // threads a block: a lane pair a row
constexpr int NV = 256;              // the first design's block: virtual threads a candidate
constexpr int CL = NV / 32;          // blocks a cluster: block c is virtual warp c
constexpr int MAXN = 8192;
constexpr int ROWS = MAXN / CL;      // rows a block keeps
constexpr int WARPS = NT / 32;
constexpr int GROUP = WARPS / 2;     // rows a virtual thread a group: 32 rows two warps
struct Rows {
  const float* p3;    // shared: 3 a row, the block's rows in order j = lane + 32 k
  const float* p2;    // 2 a row
  const uint8_t* valid;
  int n;              // the block's rows
};

// Reprojection error and depth of the block's row j under (R, t).
__device__ __forceinline__ float row_error(const Rows& rows, int j, const float* R,
                                           const float* t, const float* k4, float* depth) {
  float u, v;
  const float* X = rows.p3 + 3 * j;
  *depth = sfm_project(R, t, k4, X[0], X[1], X[2], &u, &v);
  const float du = u - rows.p2[2 * j], dv = v - rows.p2[2 * j + 1];
  return sqrtf(du * du + dv * dv);
}

// Weights of the next refit: err < thr, depth > 0, valid (and gate).
__device__ void set_weights(const Rows& rows, const float* R, const float* t,
                            const float* k4, float thr, bool gate, uint8_t* w) {
  for (int j = threadIdx.x; j < rows.n; j += NT) {
    float depth;
    const float err = row_error(rows, j, R, t, k4, &depth);
    w[j] = err < thr && depth > 0.f && rows.valid[j] && gate;
  }
  __syncthreads();
}

// Component c (0: u, 1: v) of one row's residual and Jacobian (the first
// design's expressions; c a lane's, so both components run at once).
__device__ __forceinline__ void row_jacobian(const float* X, const float* p2, const float* R,
                                             const float (*dR)[9], const float* t,
                                             const float* k4, int c, float* J, float* r) {
  float xc[3], dxc[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xc[i] = R[i * 3] * X[0] + R[i * 3 + 1] * X[1] + R[i * 3 + 2] * X[2] + t[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      dxc[i][j] = dR[j][i * 3] * X[0] + dR[j][i * 3 + 1] * X[1] + dR[j][i * 3 + 2] * X[2];
      dxc[i][3 + j] = i == j ? 1.f : 0.f;
    }
  }
  const bool clamp = fabsf(xc[2]) < 1e-12f;
  const float z = clamp ? 1e-12f : xc[2];
  const float f = c == 0 ? k4[0] : k4[1], num = f * (c == 0 ? xc[0] : xc[1]);
  *r = num / z + (c == 0 ? k4[2] : k4[3]) - p2[c];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float dz = clamp ? 0.f : dxc[2][j];
    J[j] = (f * (c == 0 ? dxc[0][j] : dxc[1][j])) / z - num * dz / (z * z);
  }
}

// The 21 J^T J and 6 J^T r terms of one row (the first design's expressions).
__device__ __forceinline__ void row_terms(const float (*J)[6], const float* r, float* term) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) term[e++] = J[0][i] * J[0][j] + J[1][i] * J[1][j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) term[21 + i] = J[0][i] * r[0] + J[1][i] * r[1];
}

// sfm_solve6(A21, g, x, shift, false) by a warp: every lane runs the same
// chain, but the divisions of a Cholesky column by its pivot are spread over
// lanes (the substitutions stay serial).
__device__ __forceinline__ void solve6_warp(const float* A21, const float* g, float* x,
                                            float shift, int lane) {
  float L[6][6];
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) L[j][i] = A21[e++] + (i == j ? shift : 0.f);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(s);
    L[j][j] = d;
    if (j == 5) break;
    float num[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float r = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) r -= L[i][k] * L[j][k];
      num[i - j - 1] = r;
    }
    const float q = sfm_lane_pick<5>(num, 5 - j, lane) / d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) L[i][j] = __shfl_sync(SFM_FULL_MASK, q, i - j - 1);
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

struct Step {
  float (*terms)[32][27];   // [GROUP][32][27]: a group of rows' terms
  uint8_t (*has)[32];       // [GROUP][32]: the row's weight is not zero
  float (*all)[CL][27];     // [2][CL][27]: every block's sums, by step parity
  float* tot;               // [27]: the candidate's sums
  float* rot;               // [36]: rodrigues(params) and its three derivatives
};

// Warp 0: rodrigues (with its derivatives) of params into s.rot, once for the
// block (every thread computed it in the first design: the same values).
__device__ __forceinline__ void rotation_warp(const float* params, int lane, const Step& s) {
  float R[9], dR[3][9];
  sfm_rodrigues_d(params, R, dR);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) s.rot[k] = R[k];
#pragma unroll
    for (int k = 0; k < 27; ++k) s.rot[9 + k] = dR[k / 9][k % 9];
  }
}

constexpr int MH = 14;   // warp 0 sums terms 0-13 of every row, warp 1 terms 14-26

// Warp 0 (M0 = 0) or 1 (M0 = MH): its lanes' sums of terms [M0, M1) over the
// group of rows k0 .. k0 + GROUP - 1, in row order.
template <int M0, int M1>
__device__ __forceinline__ void add_group(float* acc, int k0, int K, int lane, const Step& s) {
  for (int k = 0; k < GROUP && k0 + k < K; ++k) {
    if (!s.has[k][lane]) continue;
#pragma unroll
    for (int m = M0; m < M1; ++m) acc[m] += s.terms[k][lane][m];
  }
}

// Warp 0 (M0 = 0) or 1 (M0 = MH): the xor tree of its terms (every lane ends
// with the same sums), then lane r stores them in block r's all[rank].
template <int M0, int M1>
__device__ __forceinline__ void tree(cg::cluster_group& cluster, float* acc, int lane,
                                     float (*all)[27]) {
#pragma unroll
  for (int m = M0; m < M1; ++m)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[m] += __shfl_xor_sync(SFM_FULL_MASK, acc[m], off);
  if (lane < CL) {
    float* dst = cluster.map_shared_rank(&all[cluster.block_rank()][0], lane);
#pragma unroll
    for (int m = M0; m < M1; ++m) dst[m] = acc[m];
  }
}

// refine_pose_gn: iters steps from params (rvec, t), in shared memory; the
// cluster's every block runs it with the same params and ends with them.
__device__ void refine(cg::cluster_group& cluster, const Rows& rows, const uint8_t* w,
                       const float* k4, int iters, int& parity, float* params, const Step& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = (rows.n + 31) / 32;   // rows a virtual thread
  // This lane's part of a group: row k0 + kk of virtual lane l, component c.
  const int kk = warp / 2, l = 16 * (warp % 2) + lane / 2, c = lane % 2;
  if (warp == 0) rotation_warp(params, lane, s);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float R[9], dR[3][9];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = s.rot[k];
#pragma unroll
    for (int k = 0; k < 27; ++k) dR[k / 9][k % 9] = s.rot[9 + k];
    const float t[3] = {params[3], params[4], params[5]};
    float acc[27];
#pragma unroll
    for (int m = 0; m < 27; ++m) acc[m] = 0.f;
    for (int k0 = 0; k0 < K; k0 += GROUP) {
      // A lane pair forms one row: each lane its component's residual and
      // Jacobian, then both the row's terms, each lane storing half.
      const int j = l + 32 * (k0 + kk);
      const bool has = j < rows.n && w[j];
      if (__any_sync(SFM_FULL_MASK, has)) {
        float J[2][6], r[2], Jc[6], rc, term[27];
        row_jacobian(rows.p3 + 3 * (has ? j : 0), rows.p2 + 2 * (has ? j : 0), R, dR, t, k4, c,
                     Jc, &rc);
        const float ro = __shfl_xor_sync(SFM_FULL_MASK, rc, 1);
        r[0] = c == 0 ? rc : ro;
        r[1] = c == 0 ? ro : rc;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const float o = __shfl_xor_sync(SFM_FULL_MASK, Jc[q], 1);
          J[0][q] = c == 0 ? Jc[q] : o;
          J[1][q] = c == 0 ? o : Jc[q];
        }
        row_terms(J, r, term);
        if (has) {
          if (c == 0) {
#pragma unroll
            for (int m = 0; m < MH; ++m) s.terms[kk][l][m] = term[m];
          } else {
#pragma unroll
            for (int m = MH; m < 27; ++m) s.terms[kk][l][m] = term[m];
          }
        }
      }
      if (c == 0) s.has[kk][l] = has;
      __syncthreads();
      if (warp == 0) add_group<0, MH>(acc, k0, K, lane, s);
      if (warp == 1) add_group<MH, 27>(acc, k0, K, lane, s);
      __syncthreads();
    }
    if (warp == 0) tree<0, MH>(cluster, acc, lane, s.all[parity]);
    if (warp == 1) tree<MH, 27>(cluster, acc, lane, s.all[parity]);
    cluster.sync();
    if (warp == 0) {
      if (lane < 27) {   // sum m: the 8 blocks' in block order
        float v = 0.f;
#pragma unroll
        for (int b = 0; b < CL; ++b) v += s.all[parity][b][lane];
        s.tot[lane] = v;
      }
      __syncwarp();
      float delta[6];
      solve6_warp(s.tot, s.tot + 21, delta, 1e-6f, lane);  // (J^T J + 1e-6 I) delta = J^T r
      if (lane == 0)
        for (int k = 0; k < 6; ++k) params[k] -= delta[k];
      __syncwarp();
      rotation_warp(params, lane, s);   // the next step's (the last step's unused)
    }
    parity ^= 1;
    __syncthreads();
  }
}

// A block's shared memory (over the 48 KB of a static array: opted in by
// sfm_pnp_refine_setup).
struct Shared {
  float p3[ROWS * 3], p2[ROWS * 2];
  float terms[GROUP][32][27];
  float all[2][CL][27];
  float tot[27];
  float rot[36];
  float params[6];
  int count;
  uint8_t has[GROUP][32];
  uint8_t valid[ROWS], w[ROWS];
};

// A cluster of CL blocks a candidate (grid CL x B). Block c keeps rows
// n = 32 c + l + 256 k (l < 32) as its row j = l + 32 k.
__global__ void __launch_bounds__(NT) pnp_refine_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0, const uint8_t* __restrict__ ok0,
    const float* __restrict__ pts3d, const float* __restrict__ pts2d,
    const uint8_t* __restrict__ valid, const float* __restrict__ intr, int N, float thr,
    const int* __restrict__ min_inliers, int iters, float* __restrict__ R_out,
    float* __restrict__ rvec_out, float* __restrict__ t_out, uint8_t* __restrict__ inl_out,
    int* __restrict__ num_out, float* __restrict__ err_out, uint8_t* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float* sp3 = sh.p3;
  float* sp2 = sh.p2;
  uint8_t* sv = sh.valid;
  uint8_t* w = sh.w;
  float* params = sh.params;
  int& s_count = sh.count;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CL;
  const int K = (N - 32 * c + NV - 1) / NV > 0 ? (N - 32 * c + NV - 1) / NV : 0;
  const int n_rows = 32 * K;   // the block's row slots; slot j is row 32 c + j % 32 + 256 (j / 32)
  auto row_of = [&](int j) { return 32 * c + (j % 32) + NV * (j / 32); };
  for (int j = threadIdx.x; j < n_rows; j += NT) {
    const int n = row_of(j);
    const bool in = n < N;
    const size_t o = (size_t)b * N + (in ? n : 0);
    for (int k = 0; k < 3; ++k) sp3[3 * j + k] = in ? pts3d[3 * o + k] : 0.f;
    for (int k = 0; k < 2; ++k) sp2[2 * j + k] = in ? pts2d[2 * o + k] : 0.f;
    sv[j] = in && valid[o];
  }
  const Rows rows{sp3, sp2, sv, n_rows};
  const Step st{sh.terms, sh.has, sh.all, sh.tot, sh.rot};
  float k4[4];
  for (int k = 0; k < 4; ++k) k4[k] = intr[k];

  float R[9], t[3];
  for (int k = 0; k < 9; ++k) R[k] = R0[b * 9 + k];
  for (int k = 0; k < 3; ++k) t[k] = t0[b * 3 + k];
  if (threadIdx.x == 0) {
    sfm_rotation_to_rvec(R, params);
    for (int k = 0; k < 3; ++k) params[3 + k] = t[k];
    s_count = 0;
  }
  __syncthreads();
  int parity = 0;
  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier
  refine(cluster, rows, w, k4, iters, parity, params, st);

  // Re-derive the weights at the refined pose; the second refit starts from
  // rotation_to_rvec(rodrigues(params)), as refine_pose_gn does.
  sfm_rodrigues_d(params, R, nullptr);
  for (int k = 0; k < 3; ++k) t[k] = params[3 + k];
  __syncthreads();
  if (threadIdx.x == 0) sfm_rotation_to_rvec(R, params);
  set_weights(rows, R, t, k4, thr, true, w);
  refine(cluster, rows, w, k4, iters, parity, params, st);

  sfm_rodrigues_d(params, R, nullptr);
  for (int k = 0; k < 3; ++k) t[k] = params[3 + k];
  bool finite = true;
  for (int k = 0; k < 9; ++k) finite = finite && isfinite(R[k]);
  for (int k = 0; k < 3; ++k) finite = finite && isfinite(t[k]);
  int count = 0;
  for (int j = threadIdx.x; j < n_rows; j += NT) {
    const int n = row_of(j);
    if (n >= N) continue;
    float depth;
    const float err = row_error(rows, j, R, t, k4, &depth);
    const bool inl = err < thr && depth > 0.f && rows.valid[j];
    count += inl;
    inl_out[(size_t)b * N + n] = inl && finite;
    err_out[(size_t)b * N + n] = isfinite(err) ? err : INFINITY;
  }
  atomicAdd(&s_count, count);
  cluster.sync();   // every block's count in its shared memory
  if (c == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < CL; ++r) total += *cluster.map_shared_rank(&s_count, r);
    if (!finite) {
      for (int k = 0; k < 9; ++k) R[k] = k % 4 == 0 ? 1.f : 0.f;
      for (int k = 0; k < 3; ++k) t[k] = 0.f;
    }
    for (int k = 0; k < 9; ++k) R_out[b * 9 + k] = R[k];
    for (int k = 0; k < 3; ++k) t_out[b * 3 + k] = t[k];
    sfm_rotation_to_rvec(R, rvec_out + b * 3);
    num_out[b] = finite ? total : 0;
    ok_out[b] = total >= min_inliers[b] && finite;
  }
  cluster.sync();   // no block leaves while block 0 reads its count
}

}  // namespace

SFM_API int sfm_pnp_refine_setup(void* /*stream*/) {
  return static_cast<int>(cudaFuncSetAttribute(
      pnp_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Shared)));
}

SFM_API int sfm_pnp_refine(const void* R0, const void* t0, const void* ok0, const void* pts3d,
                           const void* pts2d, const void* valid, const void* intr, int B, int N,
                           float thr, const void* min_inliers, int iters, void* R, void* rvec,
                           void* t, void* inliers, void* num, void* errors, void* ok,
                           void* stream) {
  if (N > MAXN || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL * B);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = sizeof(Shared);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = CL;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, pnp_refine_kernel, static_cast<const float*>(R0), static_cast<const float*>(t0),
        static_cast<const uint8_t*>(ok0), static_cast<const float*>(pts3d),
        static_cast<const float*>(pts2d), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(intr), N, thr, static_cast<const int*>(min_inliers), iters,
        static_cast<float*>(R), static_cast<float*>(rvec), static_cast<float*>(t),
        static_cast<uint8_t*>(inliers), static_cast<int*>(num), static_cast<float*>(errors),
        static_cast<uint8_t*>(ok));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
