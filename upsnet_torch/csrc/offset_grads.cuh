// The coordinate gradients of a K-tap deformable bilinear sampler, shared by
// K8c (deform_shift.cu, the shift route's one-matmul layout) and the
// coordinate pass of the all-tap K3 (deform_sample_bwd.cu, tap-major or
// side-by-side layout).
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
// A sub-warp of `width` lanes owns a pixel, a lane takes groups of 8
// channels, and the sub-warp reduces each tap's two gradients with shuffles
// in f32: no atomics. Bound by the bytes of y, read with 16-byte loads along
// C; g is read once per tap from L1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// One corner (yy, xx) of one tap with derivative weights wy = dvy * vx and
// wx = vy * dvx: this lane's share of the two coordinate gradients.
template <typename T>
__device__ __forceinline__ void corner_grad(const T* img, int yy, int xx, float wy,
                                            float wx, const float* g, int H, int W,
                                            int64_t stride, float& gy, float& gx) {
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return;
  float v[8];
  load8(img + ((int64_t)yy * W + xx) * stride, v);
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) dot = fmaf(g[k], v[k], dot);
  gy = fmaf(wy, dot, gy);
  gx = fmaf(wx, dot, gx);
}

template <typename T>
__global__ void __launch_bounds__(256)
offset_grads_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                    const float* __restrict__ sx, const T* __restrict__ g,
                    float* __restrict__ gsy, float* __restrict__ gsx,
                    int K, int B, int H, int W, int C, int width,
                    int64_t img_stride, int64_t tap_stride, int64_t pix_stride) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t pix = tid / width;  // (b * H + i) * W + j
  const int lane = (int)(tid % width);
  const bool live = pix < plane;
  const int b = live ? (int)(pix / ((int64_t)H * W)) : 0;
  const T* img = y + (int64_t)b * img_stride;
  // every lane of the warp reaches the shuffles below, so no early return
  for (int t = 0; t < K; ++t) {
    float gy = 0.f, gx = 0.f;
    if (live) {
      const float py = __ldg(sy + t * plane + pix), px = __ldg(sx + t * plane + pix);
      if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
        const float fy = floorf(py), fx = floorf(px);
        const int y0 = (int)fy, x0 = (int)fx;
        const float ly = py - fy, lx = px - fx;
        const float hy = 1.f - ly, hx = 1.f - lx;
        // -sign(d) on |d| < 1: -1 at the low node, +1 at the high one, and
        // 0 at both when the coordinate is an integer
        const float dy0 = ly > 0.f ? -1.f : 0.f, dy1 = -dy0;
        const float dx0 = lx > 0.f ? -1.f : 0.f, dx1 = -dx0;
        for (int grp = lane; grp < groups; grp += width) {
          float gv[8];
          load8(g + pix * C + grp * 8, gv);
          const T* tap = img + t * tap_stride + grp * 8;
          corner_grad(tap, y0, x0, dy0 * hx, hy * dx0, gv, H, W, pix_stride, gy, gx);
          corner_grad(tap, y0, x0 + 1, dy0 * lx, hy * dx1, gv, H, W, pix_stride, gy, gx);
          corner_grad(tap, y0 + 1, x0, dy1 * hx, ly * dx0, gv, H, W, pix_stride, gy, gx);
          corner_grad(tap, y0 + 1, x0 + 1, dy1 * lx, ly * dx1, gv, H, W, pix_stride, gy, gx);
        }
      }
    }
    for (int off = width / 2; off > 0; off /= 2) {
      gy += __shfl_xor_sync(0xffffffffu, gy, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (lane == 0 && live) {
      gsy[t * plane + pix] = gy;
      gsx[t * plane + pix] = gx;
    }
  }
}

// Launches offset_grads_kernel over the B * H * W pixels on stream s.
template <typename T>
void launch_offset_grads(const void* y, const void* sy, const void* sx, const void* g,
                         void* gsy, void* gsx, int K, int B, int H, int W, int C,
                         int64_t img_stride, int64_t tap_stride, int64_t pix_stride,
                         cudaStream_t s) {
  const int block = 256;  // a multiple of every width
  int width = 1;
  while (width < C / 8 && width < 32) width *= 2;
  const int64_t threads = (int64_t)B * H * W * width;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  offset_grads_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const T*>(g), static_cast<float*>(gsy),
      static_cast<float*>(gsx), K, B, H, W, C, width, img_stride, tap_stride, pix_stride);
}
