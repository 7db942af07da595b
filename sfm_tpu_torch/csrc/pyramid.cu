// Kernel K3: the Gaussian scale-space pyramid with its DoG stacks, batched over
// images.
//
// Replaces sfm_tpu/features/pyramid.py::build_pyramid (:123; the shift-add blur
// of :27). The plain twin (sfm_tpu_torch/features/pyramid.py) runs each blur as
// 2R + 1 full-image multiply and add passes per direction through device
// memory; here each pass is one kernel that sums the taps in registers.
//
// What bounds it on the H100: memory traffic. Per Gaussian layer, a row pass
// and a column pass each read the image once from device memory (the taps'
// re-reads hit L1/L2) and write it once; the column pass also writes the DoG
// layer. The -1 octave of 4 images is 4 x 1536 x 2048 x 4 B = 50 MB per layer.
//
// Exactness: K4 downstream only compares DoG values, so a kernel that moves
// them by an ulp flips extrema. Every sum follows the twin's order with the
// multiply and the add rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction): taps left to right from a zero accumulator, zero padding at
// the borders; the 2x upsample is rows first, then columns, with jax.image.
// resize's renormalized edge weights; the next octave's base is layer S at
// [::2, ::2]. The pyramid is then bit-identical to the twin's.
//
// sfm_build_pyramid launches the whole pyramid on the stream: the optional
// upsample, the base blur, S + 2 incremental blurs per octave and the
// subsample between octaves. Outputs are two flat buffers holding, octave after
// octave, the (B, S + 3, h, w) Gaussian and (B, S + 2, h, w) DoG stacks.
//
// sfm_orb_blur is the same row and column pass once, the column pass rounding
// to bf16 (round to nearest even, as torch's .to(bfloat16)): the sigma = 2
// plane of kernel K12 (sfm_tpu/features/binary.py:289, features/binary.py::
// orb_blur), bit-identical to its twin orb_blur_plain.
#include <cuda_bf16.h>

#include "sfm_common.cuh"

namespace {

constexpr int MAX_TAPS = 21;  // radius <= 10: sigma <= 10/3
constexpr int MAX_BLURS = 16;

struct Taps {
  float k[MAX_TAPS];
  int radius;
};

const dim3 kBlock(32, 8);

dim3 grid_for(int h, int w, int B) {
  return dim3((w + kBlock.x - 1) / kBlock.x, (h + kBlock.y - 1) / kBlock.y, B);
}

// jax.image.resize's bilinear taps for n -> 2n at output index i: the
// triangle kernel at half-pixel centres, weights of taps outside the image
// dropped and the rest renormalized (pyramid.py::_upsample2x_taps).
__device__ __forceinline__ void upsample_taps(int i, int n, int* ia, int* ib, float* wa,
                                              float* wb) {
  const float s = __fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), 0.5f), 0.5f);
  const float i0 = floorf(s);
  const float f = __fsub_rn(s, i0);
  const int j0 = (int)i0;
  const float w0 = j0 >= 0 ? __fsub_rn(1.f, f) : 0.f;
  const float w1 = j0 + 1 <= n - 1 ? f : 0.f;
  const float tot = __fadd_rn(w0, w1);
  *ia = min(max(j0, 0), n - 1);
  *ib = min(max(j0 + 1, 0), n - 1);
  *wa = __fdiv_rn(w0, tot);
  *wb = __fdiv_rn(w1, tot);
}

// (B, H, W) -> (B, 2H, 2W): tmp = wa_r * img[ia_r] + wb_r * img[ib_r] along
// rows, then out = wa_c * tmp[:, ia_c] + wb_c * tmp[:, ib_c].
__global__ void upsample2x_kernel(const float* __restrict__ src, int H, int W,
                                  float* __restrict__ dst) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= 2 * W || y >= 2 * H) return;
  const float* img = src + (size_t)blockIdx.z * H * W;
  int ra, rb, ca, cb;
  float rwa, rwb, cwa, cwb;
  upsample_taps(y, H, &ra, &rb, &rwa, &rwb);
  upsample_taps(x, W, &ca, &cb, &cwa, &cwb);
  const float ta = __fadd_rn(__fmul_rn(rwa, img[(size_t)ra * W + ca]),
                             __fmul_rn(rwb, img[(size_t)rb * W + ca]));
  const float tb = __fadd_rn(__fmul_rn(rwa, img[(size_t)ra * W + cb]),
                             __fmul_rn(rwb, img[(size_t)rb * W + cb]));
  dst[((size_t)blockIdx.z * 2 * H + y) * 2 * W + x] =
      __fadd_rn(__fmul_rn(cwa, ta), __fmul_rn(cwb, tb));
}

// Row pass: out[y, x] = sum_i k[i] * src[y, x + i - R], zero outside.
__global__ void blur_rows_kernel(const float* __restrict__ src, size_t src_bstride, int h,
                                 int w, Taps taps, float* __restrict__ dst) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* row = src + blockIdx.z * src_bstride + (size_t)y * w;
  const int R = taps.radius;
  float acc = 0.f;
  for (int i = 0; i <= 2 * R; ++i) {
    const int xx = x + i - R;
    const float v = (xx >= 0 && xx < w) ? row[xx] : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(taps.k[i], v));
  }
  dst[((size_t)blockIdx.z * h + y) * w + x] = acc;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Column pass into Gaussian layer g (float, or bf16 for K12's plane), and
// DoG = g - prev when dog is not null.
template <typename Out>
__global__ void blur_cols_kernel(const float* __restrict__ src, int h, int w, Taps taps,
                                 Out* __restrict__ g, const float* __restrict__ prev,
                                 float* __restrict__ dog, size_t g_bstride,
                                 size_t dog_bstride) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* col = src + (size_t)blockIdx.z * h * w + x;
  const int R = taps.radius;
  float acc = 0.f;
  for (int i = 0; i <= 2 * R; ++i) {
    const int yy = y + i - R;
    const float v = (yy >= 0 && yy < h) ? col[(size_t)yy * w] : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(taps.k[i], v));
  }
  const size_t o = (size_t)y * w + x;
  store(g + blockIdx.z * g_bstride + o, acc);
  if (dog) dog[blockIdx.z * dog_bstride + o] = __fsub_rn(acc, prev[blockIdx.z * g_bstride + o]);
}

// dst (B, h2, w2) = src[::2, ::2] of a (h, w) layer with batch stride src_bstride.
__global__ void subsample2_kernel(const float* __restrict__ src, size_t src_bstride, int w,
                                  int h2, int w2, float* __restrict__ dst,
                                  size_t dst_bstride) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w2 || y >= h2) return;
  dst[blockIdx.z * dst_bstride + (size_t)y * w2 + x] =
      src[blockIdx.z * src_bstride + (size_t)(2 * y) * w + 2 * x];
}

}  // namespace

// img: (B, H, W) f32. taps_host / radii_host: host arrays of the S + 3 blurs
// (the base blur, then the S + 2 increments), MAX_TAPS floats per blur.
// scratch: 2 * B * h0 * w0 floats, (h0, w0) the first octave's size.
SFM_API int sfm_build_pyramid(const void* img, int B, int H, int W, int upsample,
                              int num_octaves, int S, const void* taps_host,
                              const void* radii_host, void* gauss, void* dogs,
                              void* scratch, void* stream) {
  const int L = S + 3;
  if (L > MAX_BLURS || B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Taps taps[MAX_BLURS];
  for (int l = 0; l < L; ++l) {
    taps[l].radius = static_cast<const int*>(radii_host)[l];
    if (taps[l].radius < 1 || 2 * taps[l].radius + 1 > MAX_TAPS)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < MAX_TAPS; ++i)
      taps[l].k[i] = static_cast<const float*>(taps_host)[l * MAX_TAPS + i];
  }
  int h = upsample ? 2 * H : H, w = upsample ? 2 * W : W;
  float* tmp = static_cast<float*>(scratch);
  float* up = tmp + (size_t)B * h * w;
  const float* base = static_cast<const float*>(img);
  if (upsample) {
    upsample2x_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(base, H, W, up);
    base = up;
  }
  float* g = static_cast<float*>(gauss);
  float* d = static_cast<float*>(dogs);
  for (int o = 0; o < num_octaves; ++o) {
    const size_t plane = (size_t)h * w;
    const size_t g_bstride = L * plane, d_bstride = (L - 1) * plane;
    if (o == 0) {  // layer 0 = the base blur of the (upsampled) image
      blur_rows_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(base, plane, h, w, taps[0], tmp);
      blur_cols_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(tmp, h, w, taps[0], g, nullptr,
                                                              nullptr, g_bstride, 0);
    }
    for (int l = 1; l < L; ++l) {
      float* prev = g + (l - 1) * plane;
      blur_rows_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(prev, g_bstride, h, w, taps[l],
                                                             tmp);
      blur_cols_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(
          tmp, h, w, taps[l], g + l * plane, prev, d + (l - 1) * plane, g_bstride, d_bstride);
    }
    const int h2 = (h + 1) / 2, w2 = (w + 1) / 2;
    float* g_next = g + B * g_bstride;
    if (o + 1 < num_octaves) {
      subsample2_kernel<<<grid_for(h2, w2, B), kBlock, 0, st>>>(
          g + S * plane, g_bstride, w, h2, w2, g_next, (size_t)L * h2 * w2);
    }
    g = g_next;
    d += B * d_bstride;
    h = h2;
    w = w2;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// img: (B, h, w) f32; taps_host: the host array of the 2R + 1 taps; scratch:
// B * h * w floats; out: (B, h, w) bf16.
SFM_API int sfm_orb_blur(const void* img, int B, int h, int w, const void* taps_host, int R,
                         void* scratch, void* out, void* stream) {
  if (R < 1 || 2 * R + 1 > MAX_TAPS || B < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Taps taps;
  taps.radius = R;
  for (int i = 0; i < MAX_TAPS; ++i)
    taps.k[i] = i <= 2 * R ? static_cast<const float*>(taps_host)[i] : 0.f;
  const size_t plane = (size_t)h * w;
  float* tmp = static_cast<float*>(scratch);
  blur_rows_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(static_cast<const float*>(img), plane,
                                                         h, w, taps, tmp);
  blur_cols_kernel<<<grid_for(h, w, B), kBlock, 0, st>>>(
      tmp, h, w, taps, static_cast<__nv_bfloat16*>(out), nullptr, nullptr, plane, 0);
  return static_cast<int>(cudaGetLastError());
}
