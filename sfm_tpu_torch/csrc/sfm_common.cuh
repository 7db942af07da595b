// Helpers shared by the port's CUDA kernels (plain C interface, loaded with
// ctypes by sfm_tpu_torch/_kernels.py). Every entry point launches on the
// stream it is given and returns cudaGetLastError().
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstddef>

#define SFM_API extern "C" __attribute__((visibility("default")))

// Python's / jnp.remainder's float modulo: the result takes the divisor's sign.
__device__ __forceinline__ float sfm_pos_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((r < 0.f) != (b < 0.f))) r += b;
  return r;
}

__device__ __forceinline__ int sfm_pos_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// (1 - f) * a + f * b, rounded after every operation (no FMA contraction),
// as the plain PyTorch twin evaluates it.
__device__ __forceinline__ float sfm_lerp_rn(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, f), a), __fmul_rn(f, b));
}

// ---- RANSAC selection shared by K2 (fmat_ransac.cu) and K6 (pnp_ransac.cu).
//
// ransac_select's rule: inliers are valid rows with error < threshold; the
// score is count - mean_inlier_error / max(threshold, 1e-6); the highest
// score wins and the first index wins a tie.
struct SfmCand {
  float score;
  int h;
  int count;
};

__device__ __forceinline__ float sfm_ransac_score(int count, float err_sum,
                                                  float thr) {
  return (float)count - (err_sum / (float)max(count, 1)) / fmaxf(thr, 1e-6f);
}

__device__ __forceinline__ SfmCand sfm_cand_max(const SfmCand& a,
                                                const SfmCand& b) {
  const bool b_wins = b.score > a.score || (b.score == a.score && b.h < a.h);
  return b_wins ? b : a;
}

// Block-wide winner of the threads' candidates (NT a multiple of 32); the
// result is valid in thread 0. Every thread of the block must call it.
template <int NT>
__device__ SfmCand sfm_block_best(SfmCand best) {
  __shared__ SfmCand warp_best[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    SfmCand o;
    o.score = __shfl_xor_sync(0xffffffffu, best.score, off);
    o.h = __shfl_xor_sync(0xffffffffu, best.h, off);
    o.count = __shfl_xor_sync(0xffffffffu, best.count, off);
    best = sfm_cand_max(best, o);
  }
  if (threadIdx.x % 32 == 0) warp_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < NT / 32; ++i) best = sfm_cand_max(best, warp_best[i]);
  }
  return best;
}

// ---- Pinhole projection as sfm_tpu_torch/geometry/projection.py::project:
// x_cam = R X + t, the depth clamped away from 0 by 1e-12, then
// u = fx * x / z + cx, v = fy * y / z + cy. Returns the depth.
__device__ __forceinline__ float sfm_project(const float* R, const float* t,
                                             const float* intr, float X0,
                                             float X1, float X2, float* u,
                                             float* v) {
  const float x = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
  const float y = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
  const float d = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
  const float z = fabsf(d) < 1e-12f ? 1e-12f : d;
  *u = intr[0] * x / z + intr[2];
  *v = intr[1] * y / z + intr[3];
  return d;
}
