// Kernel K12: the ORB-class binary frontend (two entries here; the sigma = 2
// blur of its bf16 plane is sfm_orb_blur, K3's row and column passes in
// pyramid.cu).
//
// Replaces sfm_tpu/features/binary.py::fast_scores + _nms3 and the border and
// mask gates of _detect_orb_level (:110-150, :252-269), and the per-keypoint
// patch gather, intensity-centroid angle, steering bin and steered BRIEF
// tests (:291-333).
// XLA ran FAST as 16 whole-image rolls and a windowed AND over the ring axis,
// and BRIEF as a (K, 1089) x (1089, 30 * 256) matmul of which each keypoint
// keeps one bin's 256 columns.
//
// sfm_orb_fast_nms: one 32 x 8 block per 32 x 32 output tile. The tile and a
// 4-px halo (3 for the ring, 1 for the NMS) are staged in shared memory; each
// thread scores pixels of the 34 x 34 window: the 16 ring samples against
// c + t and c - t become two 16-bit masks, and the 9-of-16 circular arc test
// is three AND-with-rotation steps (2, 4, 8 long) and one more with the mask
// rotated by 8 -- the reference's log-step windowed AND, on bits. The score
// is the passing polarity's contrast beyond t, summed in ring order; the
// BORDER band and the mask zero it; pixels outside the image are the NMS
// window's -inf padding. A pixel keeps its score if it is >= its 3 x 3
// maximum. Every sum is rounded as the plain twin rounds it (no FMA), so the
// plane is bit-identical to fast_nms_plain.
//
// sfm_orb_describe: one warp per keypoint. The 33 x 33 bf16 patch goes to
// shared memory; the moments m10 = sum(x * v), m01 = sum(y * v) over the
// radius-15 disk are summed in double, where every bf16 x integer product
// and the sum are exact (so the order does not matter), and rounded to f32
// once; angle = atan2f(m01, m10), bin = rint(angle * 30 / 2pi) mod 30 (round
// half to even, as jnp.round); bit i = patch[p_i] < patch[q_i] on the bf16
// values, written as +-1/16. The (2, 30, 256) steering tables sit in constant
// memory (copied from the wrapper's device tensor before each launch).
// Invalid rows write zeros.
//
// What bounds it on the H100: device memory and latency, not arithmetic.
// fast_nms reads each pixel once (plus a 56% halo re-read from L2) and
// writes one float: 75 MB for 12 images at 1024 x 768 (~22 us at 3.35 TB/s);
// the arc test is ~100 integer and float operations a pixel. describe writes
// 1 KB per keypoint (45,600 keypoints per 12-image batch over the three
// levels: 46.7 MB) and reads the keypoints' 33 x 33 bf16 patches, which
// overlap: at most the bf16 planes (34.9 MB), ~25 us for both; its steered
// reads from constant memory diverge across the warp (256 distinct addresses
// per table), which a later PR can move to shared memory.
#include <cuda_bf16.h>

#include "sfm_common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int FHALO = 4;                   // 3 (ring) + 1 (NMS)
constexpr int FSPAN = TILE + 2 * FHALO;    // 40
constexpr int SSPAN = TILE + 2;            // scored window: the tile + the NMS halo
constexpr int BORDER = 17;                 // HALF + 1: keypoints carry a full patch
constexpr int NT = 256;
constexpr int PATCH = 33;
constexpr int HALF = 16;
constexpr int P2 = PATCH * PATCH;
constexpr int N_BITS = 256;
constexpr int N_BINS = 30;
constexpr int DW = 8;                      // keypoints (warps) per describe block

__constant__ int16_t c_steer[2][N_BINS][N_BITS];

// The FAST ring, (dy, dx), clockwise from 12 o'clock (binary.py::_RING).
__device__ __constant__ int8_t c_ring[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3},  {1, 3},   {2, 2},   {3, 1},
    {3, 0},  {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

// Bit i of the result is bit (i + k) mod 16 of m: jnp.roll(m, -k) on the ring.
__device__ __forceinline__ uint32_t ring_rot(uint32_t m, int k) {
  return ((m >> k) | (m << (16 - k))) & 0xffffu;
}

__device__ __forceinline__ bool has_arc9(uint32_t m) {
  const uint32_t w2 = m & ring_rot(m, 1);
  const uint32_t w4 = w2 & ring_rot(w2, 2);
  const uint32_t w8 = w4 & ring_rot(w4, 4);
  return (w8 & ring_rot(m, 8)) != 0u;
}

// FAST score of the pixel at (ly, lx) of the staged tile.
__device__ __forceinline__ float fast_score(const float (*s)[FSPAN + 1], int ly, int lx,
                                            float t) {
  const float c = s[ly][lx];
  const float hi = __fadd_rn(c, t), lo = __fsub_rn(c, t);
  uint32_t mb = 0u, md = 0u;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float r = s[ly + c_ring[k][0]][lx + c_ring[k][1]];
    if (r > hi) {
      mb |= 1u << k;
      sb = __fadd_rn(sb, __fsub_rn(__fsub_rn(r, c), t));
    }
    if (r < lo) {
      md |= 1u << k;
      sd = __fadd_rn(sd, __fsub_rn(__fsub_rn(c, r), t));
    }
  }
  return fmaxf(has_arc9(mb) ? sb : 0.f, has_arc9(md) ? sd : 0.f);
}

__global__ void __launch_bounds__(NT) fast_nms_kernel(const float* __restrict__ image,
                                                      const uint8_t* __restrict__ mask, int h,
                                                      int w, float t, float* __restrict__ out) {
  __shared__ float s_img[FSPAN][FSPAN + 1];
  __shared__ float s_sc[SSPAN][SSPAN + 1];
  const size_t plane = (size_t)h * w;
  const float* im = image + blockIdx.z * plane;
  const uint8_t* mk = mask ? mask + blockIdx.z * plane : nullptr;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  for (int i = tid; i < FSPAN * FSPAN; i += NT) {
    const int y = ty0 - FHALO + i / FSPAN, x = tx0 - FHALO + i % FSPAN;
    s_img[i / FSPAN][i % FSPAN] =
        (y >= 0 && y < h && x >= 0 && x < w) ? im[(size_t)y * w + x] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < SSPAN * SSPAN; i += NT) {
    const int jy = i / SSPAN, jx = i % SSPAN;
    const int y = ty0 - 1 + jy, x = tx0 - 1 + jx;
    float sc;
    if (y < 0 || y >= h || x < 0 || x >= w)
      sc = -INFINITY;  // the NMS window's padding
    else if (y < BORDER || y >= h - BORDER || x < BORDER || x >= w - BORDER)
      sc = 0.f;        // no full patch: the ring never reads outside the image here
    else if (mk && !mk[(size_t)y * w + x])
      sc = 0.f;
    else
      sc = fast_score(s_img, jy + FHALO - 1, jx + FHALO - 1, t);
    s_sc[jy][jx] = sc;
  }
  __syncthreads();
  for (int i = tid; i < TILE * TILE; i += NT) {
    const int oy = i / TILE, ox = i % TILE;
    const int y = ty0 + oy, x = tx0 + ox;
    if (y >= h || x >= w) continue;
    const float c = s_sc[oy + 1][ox + 1];
    float m = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_sc[oy + dy][ox + dx]);
    out[blockIdx.z * plane + (size_t)y * w + x] = c >= m ? c : 0.f;
  }
}

__global__ void __launch_bounds__(DW * 32) describe_kernel(
    const __nv_bfloat16* __restrict__ blur, int h, int w, const int64_t* __restrict__ xs,
    const int64_t* __restrict__ ys, const bool* __restrict__ valid, int K, int n,
    float bin_scale, float* __restrict__ angle, float* __restrict__ desc) {
  __shared__ __nv_bfloat16 s_patch[DW][P2 + 7];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = blockIdx.x * DW + warp;
  if (kp >= n) return;
  float* d = desc + (size_t)kp * N_BITS;
  if (!valid[kp]) {
    if (lane == 0) angle[kp] = 0.f;
    for (int i = lane; i < N_BITS; i += 32) d[i] = 0.f;
    return;
  }
  // dynamic_slice's clamp of the patch origin.
  const int y0 = (int)min(max(ys[kp] - HALF, (int64_t)0), (int64_t)(h - PATCH));
  const int x0 = (int)min(max(xs[kp] - HALF, (int64_t)0), (int64_t)(w - PATCH));
  const __nv_bfloat16* src = blur + (size_t)(kp / K) * h * w + (size_t)y0 * w + x0;
  __nv_bfloat16* p = s_patch[warp];
  for (int i = lane; i < P2; i += 32) p[i] = src[(size_t)(i / PATCH) * w + i % PATCH];
  __syncwarp();
  double m10 = 0.0, m01 = 0.0;
  for (int i = lane; i < P2; i += 32) {
    const int u = i % PATCH - HALF, v = i / PATCH - HALF;
    if (u * u + v * v <= 225) {
      const double val = (double)__bfloat162float(p[i]);
      m10 += val * u;
      m01 += val * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  const float a = atan2f((float)m01, (float)m10);
  const int bin = sfm_pos_mod((int)rintf(__fmul_rn(a, bin_scale)), N_BINS);
  if (lane == 0) angle[kp] = a;
  for (int i = lane; i < N_BITS; i += 32) {
    const float vp = __bfloat162float(p[c_steer[0][bin][i]]);
    const float vq = __bfloat162float(p[c_steer[1][bin][i]]);
    d[i] = vp < vq ? 0.0625f : -0.0625f;
  }
}

}  // namespace

SFM_API int sfm_orb_fast_nms(const void* image, const void* mask, int B, int h, int w, float t,
                             void* out, void* stream) {
  const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE, B);
  fast_nms_kernel<<<grid, dim3(32, NT / 32), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const uint8_t*>(mask), h, w, t,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

SFM_API int sfm_orb_describe(const void* blur, int B, int h, int w, const void* xs,
                             const void* ys, const void* valid, int K, const void* steer,
                             float bin_scale, void* angle, void* desc, void* stream) {
  if (h < PATCH || w < PATCH) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_steer, steer, sizeof(c_steer), 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = B * K;
  if (n == 0) return 0;
  describe_kernel<<<(n + DW - 1) / DW, DW * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(blur), h, w, static_cast<const int64_t*>(xs),
      static_cast<const int64_t*>(ys), static_cast<const bool*>(valid), K, n, bin_scale,
      static_cast<float*>(angle), static_cast<float*>(desc));
  return static_cast<int>(cudaGetLastError());
}
