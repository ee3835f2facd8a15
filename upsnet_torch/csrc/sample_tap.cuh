// One bilinear sample with DCNv1 zero padding, shared by the forward
// samplers (K1, K2 in deform_sample.cu; K8a in deform_shift.cu): a sample
// counts iff it lies in (-1, H) x (-1, W), and a corner outside
// [0, H) x [0, W) reads zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// acc += wgt * img[yy, xx, 0..8). `stride` is the distance in elements
// between neighbouring pixels of img (C for a (H, W, C) map, K * C for one
// tap's block of a (H, W, K * C) map).
template <typename T>
__device__ __forceinline__ void add_corner(const T* img, int yy, int xx, float wgt,
                                           int H, int W, int stride, float* acc) {
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return;
  float v[8];
  load8(img + ((int64_t)yy * W + xx) * stride, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
}

// Adds the bilinear sample of img (one image's map, already offset to the
// thread's 8 channels) at (sy, sx) to acc.
template <typename T>
__device__ __forceinline__ void sample_tap(const T* img, float sy, float sx,
                                           int H, int W, int stride, float* acc) {
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) return;
  const float fy = floorf(sy), fx = floorf(sx);
  const int y0 = (int)fy, x0 = (int)fx;
  const float ly = sy - fy, lx = sx - fx;
  const float hy = 1.f - ly, hx = 1.f - lx;
  add_corner(img, y0, x0, hy * hx, H, W, stride, acc);
  add_corner(img, y0, x0 + 1, hy * lx, H, W, stride, acc);
  add_corner(img, y0 + 1, x0, ly * hx, H, W, stride, acc);
  add_corner(img, y0 + 1, x0 + 1, ly * lx, H, W, stride, acc);
}
