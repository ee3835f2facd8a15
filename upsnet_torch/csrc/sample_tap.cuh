// One bilinear sample with DCNv1 zero padding, shared by the forward
// samplers (K1, K2 in deform_sample.cu; K6 in deform_sample_tiled.cu; K8a in
// deform_shift.cu): a sample counts iff it lies in (-1, H) x (-1, W), and a
// corner outside [0, H) x [0, W) reads zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// acc[0..8) += wgt * v[0..8), one fmaf a channel: how every sampler adds a
// corner.
__device__ __forceinline__ void fma8(float wgt, const float* v, float* acc) {
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
}

// acc += wgt * img[yy, xx, 0..8). `stride` is the distance in elements
// between neighbouring pixels of img (C for a (H, W, C) map, K * C for one
// tap's block of a (H, W, K * C) map).
template <typename T>
__device__ __forceinline__ void add_corner(const T* img, int yy, int xx, float wgt,
                                           int H, int W, int stride, float* acc) {
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return;
  float v[8];
  load8(img + ((int64_t)yy * W + xx) * stride, v);
  fma8(wgt, v, acc);
}

// The corners of a sample at (sy, sx): the top-left one (y0, x0) and the
// weights of (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1), the
// order in which the samplers add them. False if the sample does not count.
__device__ __forceinline__ bool tap_corners(float sy, float sx, int H, int W,
                                            int* y0, int* x0, float* wgt) {
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) return false;
  const float fy = floorf(sy), fx = floorf(sx);
  *y0 = (int)fy;
  *x0 = (int)fx;
  const float ly = sy - fy, lx = sx - fx;
  const float hy = 1.f - ly, hx = 1.f - lx;
  wgt[0] = hy * hx;
  wgt[1] = hy * lx;
  wgt[2] = ly * hx;
  wgt[3] = ly * lx;
  return true;
}

// Adds the bilinear sample of img (one image's map, already offset to the
// thread's 8 channels) at (sy, sx) to acc.
template <typename T>
__device__ __forceinline__ void sample_tap(const T* img, float sy, float sx,
                                           int H, int W, int stride, float* acc) {
  int y0, x0;
  float wgt[4];
  if (!tap_corners(sy, sx, H, W, &y0, &x0, wgt)) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) add_corner(img, y0 + (q >> 1), x0 + (q & 1), wgt[q], H, W, stride, acc);
}

// sample_tap with the four corners' loads issued before the first FMA, so
// that a thread has all of them in flight at once (the all-tap forwards);
// the same sums in the same order.
template <typename T>
__device__ __forceinline__ void sample_tap_hoisted(const T* img, float sy, float sx,
                                                   int H, int W, int stride, float* acc) {
  int y0, x0;
  float wgt[4];
  if (!tap_corners(sy, sx, H, W, &y0, &x0, wgt)) return;
  Raw8<T> raw[4];  // raw words: widened only once all four are loaded
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = y0 + (q >> 1), xx = x0 + (q & 1);
    ok[q] = yy >= 0 && yy < H && xx >= 0 && xx < W;
    if (ok[q]) raw[q] = ldg8(img + ((int64_t)yy * W + xx) * stride);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!ok[q]) continue;
    float v[8];
    widen8(raw[q], v);
    fma8(wgt[q], v, acc);
  }
}
