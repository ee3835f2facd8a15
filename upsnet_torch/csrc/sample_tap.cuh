// One bilinear sample with DCNv1 zero padding, shared by the forward
// samplers (K1, K2 in deform_sample.cu; K6 in deform_sample_tiled.cu; K8a in
// deform_shift.cu) and, for its corners, the coordinate gradients
// (offset_grads.cuh): a sample counts iff it lies in (-1, H) x (-1, W), and
// a corner outside [0, H) x [0, W) reads zero. sample_taps_pixel is the whole
// body of K1, which K8a runs too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// The strides of the K tap projections of a layer in their two layouts,
// tap t of image b's pixel p at y + b * img + t * tap + p * pix: tap-major
// (K, B, H, W, C) or side by side (B, H, W, K, C), the output of one
// (N, Cin) x (Cin, K * C) matmul.
inline void layout_strides(int tap_major, int K, int B, int H, int W, int C, int64_t& img,
                           int64_t& tap, int64_t& pix) {
  if (tap_major) {
    img = (int64_t)H * W * C;
    tap = (int64_t)B * H * W * C;
    pix = C;
  } else {
    img = (int64_t)H * W * K * C;
    tap = C;
    pix = (int64_t)K * C;
  }
}

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

// The top-left corner (y0, x0) of a sample at (sy, sx) and its distances
// (ly, lx) from it along each axis. False if the sample does not count.
__device__ __forceinline__ bool tap_frac(float sy, float sx, int H, int W, int* y0, int* x0,
                                         float* ly, float* lx) {
  if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) return false;
  const float fy = floorf(sy), fx = floorf(sx);
  *y0 = (int)fy;
  *x0 = (int)fx;
  *ly = sy - fy;
  *lx = sx - fx;
  return true;
}

// The corners of a sample at (sy, sx): the top-left one (y0, x0) and the
// weights of (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1), the
// order in which the samplers add them. False if the sample does not count.
__device__ __forceinline__ bool tap_corners(float sy, float sx, int H, int W,
                                            int* y0, int* x0, float* wgt) {
  float ly, lx;
  if (!tap_frac(sy, sx, H, W, y0, x0, &ly, &lx)) return false;
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

// The body of K1 (deform_sample.cu) and K8a (deform_shift.cu). Thread `tid`
// of a launch over (pixel, group of 8 channels), group fastest, writes
// out[pix, g * 8 .. g * 8 + 8) = the sum over the taps of the bilinear
// samples of tap t at (sy[t, pix], sx[t, pix]), in f32, rounded once. y is
// read through (image, tap, pixel) strides (layout_strides). A tap's four
// corner loads are issued before its first FMA (sample_tap_hoisted) and the
// next tap's coordinates are loaded while it is summed; the taps are added
// in tap order and the corners in corner order, as sample_tap adds them, so
// both layouts give the same bits.
template <typename T>
__device__ __forceinline__ void sample_taps_pixel(const T* __restrict__ y,
                                                  const float* __restrict__ sy,
                                                  const float* __restrict__ sx,
                                                  T* __restrict__ out, int64_t tid, int taps,
                                                  int B, int H, int W, int C,
                                                  int64_t img_stride, int64_t tap_stride,
                                                  int pix_stride) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  if (tid >= plane * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  const T* img = y + (int64_t)b * img_stride + g * 8;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  float py = __ldg(sy + pix), px = __ldg(sx + pix);
  for (int t = 0; t < taps; ++t) {
    const float cy = py, cx = px;
    if (t + 1 < taps) {  // in flight while this tap is summed
      py = __ldg(sy + (t + 1) * plane + pix);
      px = __ldg(sx + (t + 1) * plane + pix);
    }
    sample_tap_hoisted(img + t * tap_stride, cy, cx, H, W, pix_stride, acc);
  }
  store8(out + pix * C + g * 8, acc);
}
