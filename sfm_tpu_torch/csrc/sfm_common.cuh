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
