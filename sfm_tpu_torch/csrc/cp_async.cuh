// Asynchronous global-to-shared copies (cp.async), shared by K1's and K1-r's
// resident tiles (dot_tile.cuh) and K5's patch staging (sift_describe.cu).
#pragma once

// 16 bytes from gmem to smem (zeros when !ok), bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok = true) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 16 : 0));
}
// 4 bytes from gmem to smem, through L1.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
