// Kernel K3: the Gaussian scale-space pyramid with its DoG stacks, batched over
// images.
//
// Replaces sfm_tpu/features/pyramid.py::build_pyramid (:123; the shift-add blur
// of :27). The plain twin (sfm_tpu_torch/features/pyramid.py) runs each blur as
// 2R + 1 full-image multiply and add passes per direction through device
// memory.
//
// What bounds it on the H100: memory traffic. Each Gaussian layer must read
// the previous layer once and write itself and its DoG once: at the -1 octave
// of 12 images a plane is 12 x 1536 x 2048 x 4 B = 151 MB. The blur's
// arithmetic (a multiply and an add per tap and direction, ~13 taps at the
// default radii) is about half that time at the f32 rate, so it has to stay out
// of its way: one kernel a Gaussian layer, a block a 32 x 64 tile of one image.
// The block loads the previous layer's tile and its halo of R pixels into
// shared memory once (cp.async, zeros outside the image), runs the row pass
// inside shared memory (4 outputs a thread, sliding along the row), the column
// pass in registers (8 outputs a thread down one column), and writes the layer
// and the DoG, g - prev, with prev taken from the same tile. The taps are
// compile-time offsets into the kernel's parameters: a template on the radius,
// instantiated for the radii of the default configuration (K3_RADII; the
// wrapper pads the taps of any other radius <= 10 up to the next of them),
// so both passes unroll. The octave's base blur reads its tile from the input
// image, or computes the 2x upsample while loading it; the next octave's first
// blur loads layer S of the previous octave at [::2, ::2] and writes that tile
// as its layer 0 (no separate subsample pass).
//
// Exactness: K4 downstream only compares DoG values, so a kernel that moves
// them by an ulp flips extrema. Every sum follows the twin's order with the
// multiply and the add rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction): taps left to right from a zero accumulator, zero padding at
// the image's border (not the tile's: a halo row or column that two tiles
// both compute gets the same value in each); the 2x upsample is rows first,
// then columns, with jax.image.resize's renormalized edge weights. A blur whose
// taps were padded adds only products 0 * v = 0 to a sum that is never -0, so
// for finite images its bits are the unpadded blur's. The pyramid is then
// bit-identical to the twin's.
//
// sfm_build_pyramid launches the whole pyramid on the stream. Outputs are two
// flat buffers holding, octave after octave, the (B, S + 3, h, w) Gaussian and
// (B, S + 2, h, w) DoG stacks.
//
// sfm_orb_blur is the same blur once, stored as bf16 (round to nearest even,
// as torch's .to(bfloat16)): the sigma = 2 plane of kernel K12
// (sfm_tpu/features/binary.py:289, features/binary.py::orb_blur),
// bit-identical to its twin orb_blur_plain.
#include <cuda_bf16.h>

#include "sfm_common.cuh"

namespace {

constexpr int MAX_TAPS = 21;  // radius <= 10
constexpr int MAX_BLURS = 16;

struct Taps {
  float k[MAX_TAPS];
};

constexpr int TW = 32;               // tile columns: a warp's
constexpr int TH = 64;               // tile rows
constexpr int NT = 256;
constexpr int CPT = TH / (NT / TW);  // column-pass outputs a thread, down one column
constexpr int RPT = 4;               // row-pass outputs a thread, along one row

// Where a layer's tile comes from: the previous layer (or the input image, for
// the base blur without upsampling), the input image upsampled 2x, or layer S
// of the previous octave at [::2, ::2].
enum Source { kPlain, kUpsample, kSubsample };

struct Layer {
  const float* src;  // (B, sh, sw) planes, src_bstride apart
  size_t src_bstride;
  int sh, sw;
  int h, w;          // this octave's plane
  void* g;           // the layer: float, or bf16 for K12's plane
  float* g0;         // kSubsample: layer 0, the source's [::2, ::2]; else null
  float* dog;        // g - the previous layer, or null
  size_t g_bstride, dog_bstride;
};

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

// 4 bytes from global to shared memory, or a zero where !ok.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One Gaussian layer: out[y, x] = sum_j k[j] * (sum_i k[i] * src[y + j - R, x + i - R]),
// zero outside the image, each sum from a zero accumulator in tap order.
template <int R, int SRC, typename Out>
__global__ void __launch_bounds__(NT) blur_layer_kernel(Layer a, Taps taps) {
  constexpr int IW = TW + 2 * R, IH = TH + 2 * R;
  constexpr int IP = IW + 1;  // odd pitches: the row pass reads and writes conflict-free
  constexpr int RP = TW + 1;
  constexpr int UN = SRC == kUpsample ? IH + IW : 1;
  __shared__ float s_in[IH * IP];
  __shared__ float s_row[IH * RP];
  __shared__ int s_ui[2 * UN];  // kUpsample: each tile row's and column's two taps
  __shared__ float s_uw[2 * UN];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int h = a.h, w = a.w;
  const float* img = a.src + blockIdx.z * a.src_bstride;

  if constexpr (SRC == kUpsample) {
    for (int e = tid; e < IH + IW; e += NT) {
      const bool row = e < IH;
      const int n = row ? a.sh : a.sw;
      const int i = row ? y0 - R + e : x0 - R + (e - IH);
      upsample_taps(min(max(i, 0), 2 * n - 1), n, &s_ui[2 * e], &s_ui[2 * e + 1], &s_uw[2 * e],
                    &s_uw[2 * e + 1]);
    }
    __syncthreads();
  }
  // The tile and its halo, zero outside the image.
  for (int e = tid; e < IH * IW; e += NT) {
    const int r = e / IW, c = e - r * IW;
    const int y = y0 - R + r, x = x0 - R + c;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    float* dst = s_in + r * IP + c;
    if constexpr (SRC == kPlain) {
      cp_async4(dst, in ? img + (size_t)y * w + x : img, in);
    } else if constexpr (SRC == kSubsample) {
      *dst = in ? img[(size_t)(2 * y) * a.sw + 2 * x] : 0.f;
    } else {
      float v = 0.f;
      if (in) {  // rows first: tmp = wa_r * img[ia_r] + wb_r * img[ib_r], then columns
        const int ra = s_ui[2 * r], rb = s_ui[2 * r + 1], ce = 2 * (IH + c);
        const int ca = s_ui[ce], cb = s_ui[ce + 1];
        const float rwa = s_uw[2 * r], rwb = s_uw[2 * r + 1], cwa = s_uw[ce], cwb = s_uw[ce + 1];
        const float ta = __fadd_rn(__fmul_rn(rwa, img[(size_t)ra * a.sw + ca]),
                                   __fmul_rn(rwb, img[(size_t)rb * a.sw + ca]));
        const float tb = __fadd_rn(__fmul_rn(rwa, img[(size_t)ra * a.sw + cb]),
                                   __fmul_rn(rwb, img[(size_t)rb * a.sw + cb]));
        v = __fadd_rn(__fmul_rn(cwa, ta), __fmul_rn(cwb, tb));
      }
      *dst = v;
    }
  }
  if constexpr (SRC == kPlain) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();

  // Row pass over every tile row, halo rows included: RPT consecutive outputs
  // a thread, each input read once and added into every output it reaches,
  // so each output's taps still arrive left to right.
  for (int it = tid; it < IH * (TW / RPT); it += NT) {
    const int r = it / (TW / RPT), c0 = (it % (TW / RPT)) * RPT;
    const float* in = s_in + r * IP + c0;
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < RPT + 2 * R; ++i) {
      const float v = in[i];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (i - j >= 0 && i - j <= 2 * R) acc[j] = __fadd_rn(acc[j], __fmul_rn(taps.k[i - j], v));
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) s_row[r * RP + c0 + j] = acc[j];
  }
  __syncthreads();

  // Column pass: CPT outputs down column tx, in registers.
  const int tx = tid % TW, ty = (tid / TW) * CPT;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < CPT + 2 * R; ++i) {
    const float v = s_row[(ty + i) * RP + tx];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (i - j >= 0 && i - j <= 2 * R) acc[j] = __fadd_rn(acc[j], __fmul_rn(taps.k[i - j], v));
  }
  const int x = x0 + tx;
  if (x >= w) return;
  Out* g = static_cast<Out*>(a.g) + blockIdx.z * a.g_bstride;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int y = y0 + ty + j;
    if (y >= h) break;
    const size_t o = (size_t)y * w + x;
    const float prev = s_in[(R + ty + j) * IP + R + tx];
    store(g + o, acc[j]);
    if (a.g0) a.g0[blockIdx.z * a.g_bstride + o] = prev;
    if (a.dog) a.dog[blockIdx.z * a.dog_bstride + o] = __fsub_rn(acc[j], prev);
  }
}

template <int SRC, typename Out>
cudaError_t launch_layer(int R, const Layer& a, const float* taps_host, int B, cudaStream_t st) {
  Taps t;
  for (int i = 0; i < MAX_TAPS; ++i) t.k[i] = i <= 2 * R ? taps_host[i] : 0.f;
  const dim3 grid((a.w + TW - 1) / TW, (a.h + TH - 1) / TH, B);
  switch (R) {  // K3_RADII in features/pyramid.py
#define K3_CASE(r) \
  case r:          \
    blur_layer_kernel<r, SRC, Out><<<grid, NT, 0, st>>>(a, t); \
    break;
    K3_CASE(4)
    K3_CASE(5)
    K3_CASE(6)
    K3_CASE(8)
    K3_CASE(10)
#undef K3_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// img: (B, H, W) f32. taps_host / radii_host: host arrays of the S + 3 blurs
// (the base blur, then the S + 2 increments): each blur's kernel radius (one
// of K3_RADII) and its taps, MAX_TAPS floats per blur, centred in the first
// 2 radius + 1.
SFM_API int sfm_build_pyramid(const void* img, int B, int H, int W, int upsample,
                              int num_octaves, int S, const void* taps_host,
                              const void* radii_host, void* gauss, void* dogs, void* stream) {
  const int L = S + 3;
  if (L > MAX_BLURS || B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* taps = static_cast<const float*>(taps_host);
  const int* radii = static_cast<const int*>(radii_host);
  int h = upsample ? 2 * H : H, w = upsample ? 2 * W : W;
  float* g = static_cast<float*>(gauss);
  float* d = static_cast<float*>(dogs);
  const float* prev_s = nullptr;  // layer S of the previous octave
  size_t prev_bstride = 0;
  int ph = 0, pw = 0;
  for (int o = 0; o < num_octaves; ++o) {
    const size_t plane = (size_t)h * w;
    const size_t g_bstride = L * plane, d_bstride = (L - 1) * plane;
    for (int l = o == 0 ? 0 : 1; l < L; ++l) {
      Layer a{};
      a.h = h;
      a.w = w;
      a.g = g + l * plane;
      a.g_bstride = g_bstride;
      a.dog_bstride = d_bstride;
      if (l > 0) a.dog = d + (l - 1) * plane;
      cudaError_t e;
      if (l == 0) {  // the base blur of the (upsampled) image
        a.src = static_cast<const float*>(img);
        a.src_bstride = (size_t)H * W;
        a.sh = H;
        a.sw = W;
        e = upsample ? launch_layer<kUpsample, float>(radii[0], a, taps, B, st)
                     : launch_layer<kPlain, float>(radii[0], a, taps, B, st);
      } else if (o > 0 && l == 1) {  // layer 0 is the previous octave's layer S at [::2, ::2]
        a.src = prev_s;
        a.src_bstride = prev_bstride;
        a.sh = ph;
        a.sw = pw;
        a.g0 = g;
        e = launch_layer<kSubsample, float>(radii[1], a, taps + MAX_TAPS, B, st);
      } else {
        a.src = g + (l - 1) * plane;
        a.src_bstride = g_bstride;
        a.sh = h;
        a.sw = w;
        e = launch_layer<kPlain, float>(radii[l], a, taps + l * MAX_TAPS, B, st);
      }
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    prev_s = g + S * plane;
    prev_bstride = g_bstride;
    ph = h;
    pw = w;
    g += B * g_bstride;
    d += B * d_bstride;
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
  return static_cast<int>(cudaGetLastError());
}

// img: (B, h, w) f32; taps_host: the host array of the 2R + 1 taps, R one of
// K3_RADII; out: (B, h, w) bf16.
SFM_API int sfm_orb_blur(const void* img, int B, int h, int w, const void* taps_host, int R,
                         void* out, void* stream) {
  if (R < 1 || 2 * R + 1 > MAX_TAPS || B < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Layer a{};
  a.src = static_cast<const float*>(img);
  a.src_bstride = a.g_bstride = (size_t)h * w;
  a.sh = a.h = h;
  a.sw = a.w = w;
  a.g = out;
  return static_cast<int>(launch_layer<kPlain, __nv_bfloat16>(
      R, a, static_cast<const float*>(taps_host), B, static_cast<cudaStream_t>(stream)));
}
