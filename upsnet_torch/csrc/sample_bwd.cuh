// One bilinear sample's backward, shared by K3 (deform_sample_bwd.cu) and
// K7b (deform_sample_mt_bwd.cu).
//
// For out[:] = sum_{r, q} vy_r * vx_q * img[r, q, :] with the hat weights
// vy_r = max(0, 1 - |sy - r|), vx_q = max(0, 1 - |sx - q|) and DCNv1 zero
// padding (the sample counts iff it lies in (-1, H) x (-1, W); rows and
// columns outside the map read zero), given g = d loss / d out:
//
//   canvas[r, q, :] += vy_r * vx_q * g[:]                       (f32 atomics)
//   gy = sum_c g_c * sum_{r, q} dvy_r *  vx_q * img[r, q, c]
//   gx = sum_c g_c * sum_{r, q}  vy_r * dvx_q * img[r, q, c]
//
// with dv = -sign(d) where |d| < 1, else 0: at an integer coordinate d = 0
// at the peak and |d| = 1 at its neighbours, so every derivative there is 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// One corner (yy, xx) with weight w = vy * vx and derivative weights
// wy = dvy * vx, wx = vy * dvx: scatter w * g, and add this lane's share of
// the coordinate gradients.
template <typename T>
__device__ __forceinline__ void corner_bwd(const T* img, float* canvas, int yy, int xx,
                                           float w, float wy, float wx, const float* g,
                                           int H, int W, int C, float& gy, float& gx) {
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return;
  const int64_t off = ((int64_t)yy * W + xx) * C;
  float v[8], add[8];
  load8(img + off, v);
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dot = fmaf(g[k], v[k], dot);
    add[k] = w * g[k];
  }
  gy = fmaf(wy, dot, gy);
  gx = fmaf(wx, dot, gx);
  if (w != 0.f) atomic_add8(canvas + off, add);
}

// A lane's share of the sample at (py, px): it takes the channel groups
// lane, lane + width, ... of the C channels. img and canvas point at the
// sample's image, g at the C upstream gradients of the sample. Adds the
// lane's partial coordinate gradients to gy, gx; the caller reduces them
// over the `width` lanes.
template <typename T>
__device__ __forceinline__ void sample_bwd(const T* img, float* canvas, const T* g,
                                           float py, float px, int H, int W, int C,
                                           int lane, int width, float& gy, float& gx) {
  if (!(py > -1.f && py < (float)H && px > -1.f && px < (float)W)) return;
  const float fy = floorf(py), fx = floorf(px);
  const int y0 = (int)fy, x0 = (int)fx;
  const float ly = py - fy, lx = px - fx;
  const float hy = 1.f - ly, hx = 1.f - lx;
  // -sign(d) on |d| < 1: -1 at the low node, +1 at the high one, and 0 at
  // both when the coordinate is an integer
  const float dy0 = ly > 0.f ? -1.f : 0.f, dy1 = -dy0;
  const float dx0 = lx > 0.f ? -1.f : 0.f, dx1 = -dx0;
  for (int grp = lane; grp < C / 8; grp += width) {
    float gv[8];
    load8(g + grp * 8, gv);
    const T* im = img + grp * 8;
    float* cv = canvas + grp * 8;
    corner_bwd(im, cv, y0, x0, hy * hx, dy0 * hx, hy * dx0, gv, H, W, C, gy, gx);
    corner_bwd(im, cv, y0, x0 + 1, hy * lx, dy0 * lx, hy * dx1, gv, H, W, C, gy, gx);
    corner_bwd(im, cv, y0 + 1, x0, ly * hx, dy1 * hx, ly * dx0, gv, H, W, C, gy, gx);
    corner_bwd(im, cv, y0 + 1, x0 + 1, ly * lx, dy1 * lx, ly * dx1, gv, H, W, C, gy, gx);
  }
}

// The sub-warp width for C channels: a power of two <= 32, at least C / 8
// when that fits.
inline int sub_warp_width(int C) {
  int width = 1;
  while (width < C / 8 && width < 32) width *= 2;
  return width;
}
