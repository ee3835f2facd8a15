// The coordinate gradients of a K-tap deformable bilinear sampler, shared by
// K8c (deform_shift.cu, the shift route's one-matmul layout) and the
// coordinate pass of both all-tap K3 forms (deform_sample_bwd.cu, tap-major
// or side-by-side layout).
//
// With tap t's map of image b at y + b * img_stride + t * tap_stride, pixel
// (r, q) of it at (r * W + q) * pix_stride, and hat weights
// vy_r = max(0, 1 - |sy - r|), vx_q = max(0, 1 - |sx - q|) under DCNv1 zero
// padding (a sample counts iff it lies in (-1, H) x (-1, W); rows and columns
// outside the map read zero):
//
//   gsy[t, b, i, j] = sum_c g[b, i, j, c] * sum_{r, q} dvy_r *  vx_q * y_t[b, r, q, c]
//   gsx[t, b, i, j] = sum_c g[b, i, j, c] * sum_{r, q}  vy_r * dvx_q * y_t[b, r, q, c]
//
// with dv = -sign(d) where |d| < 1, else 0: every derivative is exactly 0 at
// an integer coordinate (d = 0 at the peak, |d| = 1 at its neighbours).
//
// A sub-warp of WIDTH lanes owns a pixel (16 at C 128, the least power of
// two >= C / 8, at most 32), a lane a group of 8 channels, as in K1: the
// lane loads its 8 channels of g once, then walks the taps with the next
// tap's coordinates in flight, issues the raw words of a tap's four corners
// before it uses any (predicated loads, none behind a branch; tap_frac of
// sample_tap.cuh gives the corners and their distances) and stores its two
// partial sums of the tap in shared memory. After the taps of a chunk (up to
// kChunk = 9, a 3 x 3 layer's taps) a thread per (tap, gy or gx, pixel) sums
// the WIDTH partials in lane order and writes them, neighbouring pixels
// together. Nothing is carried across taps in registers and no shuffle
// chain sits between two taps' loads, so a thread needs about as many
// registers as K1 (60 at bf16) and an SM holds as many threads. Fixed order
// throughout, so two runs give the same bits; no atomics. Bound by the bytes
// of y (the touched corners), read with 16-byte loads along C through L1/L2:
// a block's footprint at reach 7 (16 rows of 48 pixels, 2304 B a pixel side
// by side) does not fit shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "vec8.cuh"

namespace offset_grads {

constexpr int kBlock = 256;  // threads a block: a multiple of every WIDTH
constexpr int kChunk = 9;    // taps a pass over shared memory takes

// One tap of one group of 8 channels: this lane's share of the two
// coordinate gradients, added to gy and gx. The corners' loads are issued
// before any is used, and predicated: a sample that does not count, or a
// corner outside the map, loads nothing and adds nothing.
template <typename T>
__device__ __forceinline__ void tap_grad(const T* tap, float sy, float sx, int H, int W,
                                         int64_t stride, const float* gv, float& gy,
                                         float& gx) {
  int y0 = 0, x0 = 0;
  float ly = 0.f, lx = 0.f;
  const bool inside = tap_frac(sy, sx, H, W, &y0, &x0, &ly, &lx);
  const float hy = 1.f - ly, hx = 1.f - lx;
  // -sign(d) on |d| < 1: -1 at the low node, +1 at the high one, and 0 at
  // both when the coordinate is an integer
  const float dy0 = ly > 0.f ? -1.f : 0.f, dx0 = lx > 0.f ? -1.f : 0.f;
  // corner order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1):
  // wy = dvy * vx, wx = vy * dvx
  const float wy[4] = {dy0 * hx, dy0 * lx, -dy0 * hx, -dy0 * lx};
  const float wx[4] = {hy * dx0, -hy * dx0, ly * dx0, -ly * dx0};
  Raw8<T> raw[4];
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = y0 + (q >> 1), xx = x0 + (q & 1);
    ok[q] = inside && yy >= 0 && yy < H && xx >= 0 && xx < W;
    if (ok[q]) raw[q] = ldg8(tap + ((int64_t)yy * W + xx) * stride);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!ok[q]) continue;
    float v[8];
    widen8(raw[q], v);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) dot = fmaf(gv[k], v[k], dot);
    gy = fmaf(wy[q], dot, gy);
    gx = fmaf(wx[q], dot, gx);
  }
}

template <typename T, int WIDTH>
__global__ void __launch_bounds__(kBlock)
offset_grads_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                    const float* __restrict__ sx, const T* __restrict__ g,
                    float* __restrict__ gsy, float* __restrict__ gsx,
                    int K, int B, int H, int W, int C,
                    int64_t img_stride, int64_t tap_stride, int64_t pix_stride) {
  constexpr int kPix = kBlock / WIDTH;      // pixels a block owns
  constexpr int kRow = kChunk * WIDTH + 1;  // a pixel's partial sums, padded against conflicts
  __shared__ float part[2][kPix * kRow];    // gy, gx: [pixel][tap][lane]
  const int groups = C / 8;
  const bool many = groups > WIDTH;  // a lane owns several groups (C > 256)
  const int64_t plane = (int64_t)B * H * W;
  const int p = threadIdx.x / WIDTH, lane = threadIdx.x % WIDTH;
  const int64_t pix0 = (int64_t)blockIdx.x * kPix;
  const int64_t pix = pix0 + p;  // (b * H + i) * W + j
  const bool live = pix < plane;
  const int b = live ? (int)(pix / ((int64_t)H * W)) : 0;
  const T* img = y + (int64_t)b * img_stride;
  float gv[8];
  if (live && !many && lane < groups) load8(g + pix * C + lane * 8, gv);
  // every thread of the block reaches the barriers, so no early return
  for (int t0 = 0; t0 < K; t0 += kChunk) {
    const int n = min(kChunk, K - t0);
    float py = live ? __ldg(sy + t0 * plane + pix) : -2.f;  // -2: does not count
    float px = live ? __ldg(sx + t0 * plane + pix) : -2.f;
    for (int u = 0; u < n; ++u) {
      const float cy = py, cx = px;
      if (live && u + 1 < n) {  // in flight while this tap is summed
        py = __ldg(sy + (t0 + u + 1) * plane + pix);
        px = __ldg(sx + (t0 + u + 1) * plane + pix);
      }
      float gy = 0.f, gx = 0.f;
      for (int grp = lane; live && grp < groups; grp += WIDTH) {
        if (many) load8(g + pix * C + grp * 8, gv);
        tap_grad(img + (t0 + u) * tap_stride + grp * 8, cy, cx, H, W, pix_stride, gv, gy, gx);
      }
      part[0][p * kRow + u * WIDTH + lane] = gy;
      part[1][p * kRow + u * WIDTH + lane] = gx;
    }
    __syncthreads();
    // a thread per (tap, gy or gx, pixel), the pixel fastest: the sum over
    // the lanes in lane order, written with its neighbours' pixels
    for (int i = threadIdx.x; i < 2 * n * kPix; i += kBlock) {
      const int q = i % kPix, comp = (i / kPix) & 1, u = i / (2 * kPix);
      const float* src = part[comp] + q * kRow + u * WIDTH;
      float sum = 0.f;
#pragma unroll
      for (int l = 0; l < WIDTH; ++l) sum += src[l];
      if (pix0 + q < plane) (comp ? gsx : gsy)[(t0 + u) * plane + pix0 + q] = sum;
    }
    __syncthreads();
  }
}

template <typename T, int WIDTH>
void launch(const void* y, const void* sy, const void* sx, const void* g, void* gsy,
            void* gsx, int K, int B, int H, int W, int C, int64_t img_stride,
            int64_t tap_stride, int64_t pix_stride, cudaStream_t s) {
  const int64_t threads = (int64_t)B * H * W * WIDTH;
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  offset_grads_kernel<T, WIDTH><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const T*>(g), static_cast<float*>(gsy),
      static_cast<float*>(gsx), K, B, H, W, C, img_stride, tap_stride, pix_stride);
}

}  // namespace offset_grads

// Launches offset_grads_kernel over the B * H * W pixels on stream s, with
// a sub-warp of the least power of two >= C / 8 lanes (at most 32) a pixel;
// a lane takes several groups only when C > 256.
template <typename T>
void launch_offset_grads(const void* y, const void* sy, const void* sx, const void* g,
                         void* gsy, void* gsx, int K, int B, int H, int W, int C,
                         int64_t img_stride, int64_t tap_stride, int64_t pix_stride,
                         cudaStream_t s) {
  const int groups = C / 8;
#define OFFSET_GRADS_LAUNCH(WIDTH)                                                       \
  offset_grads::launch<T, WIDTH>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img_stride,     \
                                 tap_stride, pix_stride, s)
  if (groups <= 1) OFFSET_GRADS_LAUNCH(1);
  else if (groups <= 2) OFFSET_GRADS_LAUNCH(2);
  else if (groups <= 4) OFFSET_GRADS_LAUNCH(4);
  else if (groups <= 8) OFFSET_GRADS_LAUNCH(8);
  else if (groups <= 16) OFFSET_GRADS_LAUNCH(16);
  else OFFSET_GRADS_LAUNCH(32);
#undef OFFSET_GRADS_LAUNCH
}
