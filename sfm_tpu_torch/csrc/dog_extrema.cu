// Kernel K4: strict 26-neighbour scale-space extrema of a DoG stack, scored by |DoG|.
//
// Replaces sfm_tpu/features/detect.py::dog_extrema_scores (the separable
// reduce-window program; its oracle _dog_extrema_scores_ref is the semantics):
// a pixel of interior layer s scores |D| when it is strictly greater (or
// strictly smaller) than all 26 neighbours, lies at least 5 px inside the image
// and |D| >= contrast_threshold / 2; every other pixel scores 0. Compares only,
// so the result is bit-exact against the plain twin.
//
// What bounds it on the H100: device memory. The function reads the S + 2 DoG
// planes once and writes the S score planes: (S + 2 + S) * 4 bytes per pixel,
// 12.6 MB per image at the 1536 x 2048 octave -1.
//
// Design: a block of 128 threads is a 64 x 16 tile of one image over all S
// interior layers. It stages the tile and its halo (one row above and below,
// four columns each side so that every copy is 16 bytes) of all S + 2 planes
// in shared memory with cp.async, one commit group a plane, and starts on
// plane 0 while the later planes arrive, so each DoG value leaves device
// memory about once. A thread owns 4 columns x 2 rows of outputs: for each
// plane it loads its 4 x 6 window from shared memory and takes the plane's 3 x 3
// maximum and minimum around each output (NaN-propagating, so a NaN anywhere
// fails the strict compare as it does there) and, for the centre plane, the 8
// neighbours'; layer s then compares its centre with the extreme of planes
// s - 1, s (without the centre) and s + 1, which holds exactly when all 26
// strict compares hold. The scores go out as 16-byte stores in the (B, S, h,
// w) layout that dog_select reads. A width that is not a multiple of 4 (or a
// plane not 16-byte aligned) takes 4-byte copies and stores. jnp.roll's wrap
// at the image edge is not reproduced: the 5-px border keeps every wrapped
// value away from a scored pixel.
#include "sfm_common.cuh"

namespace {

constexpr int BORDER = 5;
constexpr int NT = 128;
constexpr int TW = 64, TH = 16;          // outputs of a tile: 16 x 8 threads of 4 x 2
constexpr int SW = TW + 8, SH = TH + 2;  // its staged rows and columns (halo 4 x 1)
constexpr int MAX_PLANES = 16;

__device__ __forceinline__ float maxn(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float minn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// Wait until at most n of this thread's commit groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(NT, 4) dog_extrema_kernel(const float* __restrict__ dog, int Sp2,
                                                         int h, int w, float thr, bool vec,
                                                         float* __restrict__ score) {
  extern __shared__ __align__(16) float st[];   // Sp2 planes of SH x SW
  const int S = Sp2 - 2, b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = (size_t)h * w;

  // Stage every plane's tile and halo: image row y0 - 1 + r, column x0 - 4 + c.
  for (int p = 0; p < Sp2; ++p) {
    const float* src = dog + ((size_t)b * Sp2 + p) * plane;
    float* dst = st + p * SH * SW;
    for (int i = threadIdx.x; i < SH * (SW / 4); i += NT) {
      const int r = i / (SW / 4), c = 4 * (i % (SW / 4));
      const int gy = y0 - 1 + r, gx = x0 - 4 + c;
      if (gy < 0 || gy >= h) continue;
      if (vec) {
        if (gx >= 0 && gx + 3 < w) cp_async16(dst + r * SW + c, src + (size_t)gy * w + gx);
      } else {
        for (int e = 0; e < 4; ++e)
          if (gx + e >= 0 && gx + e < w)
            cp_async4(dst + r * SW + c + e, src + (size_t)gy * w + gx + e);
      }
    }
    cp_async_commit();
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // Per output (oy, ox) = (i / 4, i % 4): the running extremes of the layer
  // centred on the previous plane, its centre, and the previous plane's 3 x 3
  // extremes.
  float qmax[8], qmin[8], cprev[8], pmax[8], pmin[8];
  for (int p = 0; p < Sp2; ++p) {
    cp_async_wait(min(Sp2 - 1 - p, 7));
    __syncthreads();
    const float* sp = st + p * SH * SW;
    float wv[4][6];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* row = sp + (2 * ty + r) * SW + 4 * tx + 3;
      const float4 mid = *reinterpret_cast<const float4*>(row + 1);
      wv[r][0] = row[0];
      wv[r][1] = mid.x;
      wv[r][2] = mid.y;
      wv[r][3] = mid.z;
      wv[r][4] = mid.w;
      wv[r][5] = row[5];
    }
    float hmax[4][4], hmin[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hmax[r][i] = maxn(maxn(wv[r][i], wv[r][i + 1]), wv[r][i + 2]);
        hmin[r][i] = minn(minn(wv[r][i], wv[r][i + 1]), wv[r][i + 2]);
      }
    const bool centre = p >= 1 && p <= S;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int oy = o / 4, ox = o % 4;
      const float m9max = maxn(maxn(hmax[oy][ox], hmax[oy + 1][ox]), hmax[oy + 2][ox]);
      const float m9min = minn(minn(hmin[oy][ox], hmin[oy + 1][ox]), hmin[oy + 2][ox]);
      if (p >= 2) {   // layer p - 1 is complete: compare and store
        const float c = cprev[o];
        const bool is_max = c > maxn(qmax[o], m9max);
        const bool is_min = c < minn(qmin[o], m9min);
        const int y = y0 + 2 * ty + oy, x = x0 + 4 * tx + ox;
        const bool inside = y >= BORDER && y < h - BORDER && x >= BORDER && x < w - BORDER;
        const float raw = fabsf(c);
        cprev[o] = (is_max || is_min) && inside && raw >= thr ? raw : 0.f;  // the score
      }
      if (centre) {
        // Plane p's 8 neighbours of the centre, then with plane p - 1's 9.
        const float c = wv[oy + 1][ox + 1];
        const float m8max = maxn(maxn(maxn(hmax[oy][ox], hmax[oy + 2][ox]), wv[oy + 1][ox]),
                                 wv[oy + 1][ox + 2]);
        const float m8min = minn(minn(minn(hmin[oy][ox], hmin[oy + 2][ox]), wv[oy + 1][ox]),
                                 wv[oy + 1][ox + 2]);
        qmax[o] = maxn(pmax[o], m8max);
        qmin[o] = minn(pmin[o], m8min);
        if (p < 2) cprev[o] = c;
      }
      pmax[o] = m9max;
      pmin[o] = m9min;
    }
    if (p >= 2) {   // store layer p - 1's scores (interior layer index p - 2)
      float* out = score + ((size_t)b * S + (p - 2)) * plane;
#pragma unroll
      for (int oy = 0; oy < 2; ++oy) {
        const int y = y0 + 2 * ty + oy, x = x0 + 4 * tx;
        if (y >= h) continue;
        float* dst = out + (size_t)y * w + x;
        if (vec && x + 3 < w) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(cprev[4 * oy], cprev[4 * oy + 1], cprev[4 * oy + 2], cprev[4 * oy + 3]);
        } else {
#pragma unroll
          for (int ox = 0; ox < 4; ++ox)
            if (x + ox < w) dst[ox] = cprev[4 * oy + ox];
        }
      }
#pragma unroll
      for (int o = 0; o < 8; ++o) {   // the next layer's centre
        if (centre) cprev[o] = wv[o / 4 + 1][o % 4 + 1];
      }
    }
  }
}

}  // namespace

// The staged planes' shared memory above 48 KB (up to MAX_PLANES planes).
SFM_API int sfm_dog_extrema_setup(void* stream) {
  (void)stream;
  return static_cast<int>(cudaFuncSetAttribute(
      dog_extrema_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_PLANES * SH * SW * static_cast<int>(sizeof(float))));
}

SFM_API int sfm_dog_extrema(const void* dog, int B, int Sp2, int h, int w, float thr,
                            void* score, void* stream) {
  if (Sp2 < 3 || Sp2 > MAX_PLANES) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
  const size_t smem = (size_t)Sp2 * SH * SW * sizeof(float);
  // 16-byte copies and stores: rows of a multiple of 4 floats, aligned planes.
  const bool vec = (w & 3) == 0 && reinterpret_cast<uintptr_t>(dog) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(score) % 16 == 0;
  dog_extrema_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dog), Sp2, h, w, thr, vec, static_cast<float*>(score));
  return static_cast<int>(cudaGetLastError());
}
