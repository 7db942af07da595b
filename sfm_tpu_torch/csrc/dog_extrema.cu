// Kernel K4: strict 26-neighbour scale-space extrema of a DoG stack, scored by |DoG|.
//
// Replaces sfm_tpu/features/detect.py::dog_extrema_scores (the separable
// reduce-window program; its oracle _dog_extrema_scores_ref is the semantics):
// a pixel of interior layer s scores |D| when it is strictly greater (or
// strictly smaller) than all 26 neighbours, lies at least 5 px inside the image
// and |D| >= contrast_threshold / 2; every other pixel scores 0. Compares only,
// so the result is bit-exact against the plain twin.
//
// What bounds it on the H100: device memory. Per interior pixel it reads 27
// floats (from L1/L2: neighbouring threads share 26 of them) and writes one;
// the ideal traffic is (S + 2 + S) * 4 bytes per pixel, 12.6 MB per image at
// the 1536 x 2048 octave -1.
//
// Design (simple first): one thread per output pixel, 32 x 8 blocks, one grid
// z-slice per (image, interior layer); neighbours come straight from global
// memory through the read-only cache. jnp.roll's wrap at the image edge is
// not reproduced: the 5-px border keeps every wrapped value away from a scored
// pixel.
#include "sfm_common.cuh"

namespace {

constexpr int BORDER = 5;

__global__ void dog_extrema_kernel(const float* __restrict__ dog, int Sp2, int h,
                                   int w, float thr, float* __restrict__ score) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int S = Sp2 - 2;
  const int b = blockIdx.z / S;
  const int s = blockIdx.z % S;
  const size_t plane = (size_t)h * w;
  float out = 0.f;
  if (y >= BORDER && y < h - BORDER && x >= BORDER && x < w - BORDER) {
    const float* center = dog + ((size_t)b * Sp2 + s + 1) * plane;
    const float c = __ldg(center + (size_t)y * w + x);
    bool is_max = true, is_min = true;
#pragma unroll
    for (int ds = -1; ds <= 1; ++ds) {
      const float* layer = center + (ptrdiff_t)ds * (ptrdiff_t)plane;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (ds == 0 && dy == 0 && dx == 0) continue;
          const float v = __ldg(layer + (size_t)(y + dy) * w + (x + dx));
          is_max &= c > v;
          is_min &= c < v;
        }
      }
    }
    const float raw = fabsf(c);
    if ((is_max || is_min) && raw >= thr) out = raw;
  }
  score[(size_t)blockIdx.z * plane + (size_t)y * w + x] = out;
}

}  // namespace

SFM_API int sfm_dog_extrema(const void* dog, int B, int Sp2, int h, int w,
                            float thr, void* score, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8, B * (Sp2 - 2));
  dog_extrema_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dog), Sp2, h, w, thr, static_cast<float*>(score));
  return static_cast<int>(cudaGetLastError());
}
