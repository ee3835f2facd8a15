// One bilinear sample with DCNv1 zero padding, shared by the forward
// samplers (K1, K2 in deform_sample.cu; K6 in deform_sample_tiled.cu; K7a in
// deform_sample_mt.cu; K8a in deform_shift.cu) and, for its corners, the
// coordinate gradients (offset_grads.cuh): a sample counts iff it lies in
// (-1, H) x (-1, W), and a corner outside [0, H) x [0, W) reads zero.
// sample_taps_pixel is the whole body of K1, which K8a runs too, and
// sample_each_tap_pixel that of K7a.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

// The strides of a layer's K tap projections side by side (B, H, W, K, C),
// the output of one (N, Cin) x (Cin, K * C) matmul: tap t of image b's pixel
// p at y + b * img + t * tap + p * pix.
inline void side_by_side_strides(int K, int H, int W, int C, int64_t& img, int64_t& tap,
                                 int64_t& pix) {
  img = (int64_t)H * W * K * C;
  tap = C;
  pix = (int64_t)K * C;
}

// acc[0..8) += wgt * v[0..8), one fmaf a channel: how every sampler adds a
// corner.
__device__ __forceinline__ void fma8(float wgt, const float* v, float* acc) {
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
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
// thread's 8 channels, `stride` elements between neighbouring pixels: C for
// a (H, W, C) map, K * C for one tap's block of a (H, W, K * C) map) at
// (sy, sx) to acc, one fmaf a channel and corner in corner order. The four
// corners' loads are issued before the first FMA, so that a thread has all
// of them in flight at once.
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

// Calls tap(t, sy, sx) for the taps t = 0 .. taps - 1 of output pixel `pix`
// in order, with tap t's coordinates at sy[t * plane + pix], sx[...]; the
// next tap's coordinates are loaded while tap t is used.
template <typename F>
__device__ __forceinline__ void walk_taps(const float* __restrict__ sy,
                                          const float* __restrict__ sx, int64_t plane,
                                          int64_t pix, int taps, F&& tap) {
  float py = __ldg(sy + pix), px = __ldg(sx + pix);
  for (int t = 0; t < taps; ++t) {
    const float cy = py, cx = px;
    if (t + 1 < taps) {  // in flight while this tap is used
      py = __ldg(sy + (t + 1) * plane + pix);
      px = __ldg(sx + (t + 1) * plane + pix);
    }
    tap(t, cy, cx);
  }
}

// The body of K1 (deform_sample.cu) and K8a (deform_shift.cu). Thread `tid`
// of a launch over (pixel, group of 8 channels), group fastest, writes
// out[pix, g * 8 .. g * 8 + 8) = the sum over the taps of the bilinear
// samples of tap t at (sy[t, pix], sx[t, pix]), in f32, rounded once. y is
// read through (image, tap, pixel) strides (side_by_side_strides). A tap's
// four corner loads are issued before its first FMA (sample_tap_hoisted) and
// the next tap's coordinates are loaded while it is summed (walk_taps); the
// taps are added in tap order and the corners in corner order.
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
  walk_taps(sy, sx, plane, pix, taps, [&](int t, float cy, float cx) {
    sample_tap_hoisted(img + t * tap_stride, cy, cx, H, W, pix_stride, acc);
  });
  store8(out + pix * C + g * 8, acc);
}

// The body of K7a (deform_sample_mt.cu): sample_taps_pixel with each tap
// kept apart. Thread `tid` of a launch over (pixel, group of 8 channels),
// group fastest, with a 32-bit index (the caller keeps B * H * W * C / 8
// below 2^31), writes cols[pix, t, g * 8 .. g * 8 + 8) = the bilinear sample
// of x (B, H, W, C) at (sy[t, pix], sx[t, pix]), in f32 from a fresh
// accumulator, rounded once; cols (B, H, W, taps, C).
template <typename T>
__device__ __forceinline__ void sample_each_tap_pixel(const T* __restrict__ x,
                                                      const float* __restrict__ sy,
                                                      const float* __restrict__ sx,
                                                      T* __restrict__ cols, unsigned tid,
                                                      int taps, int B, int H, int W, int C) {
  const unsigned groups = C / 8;
  const unsigned hw = (unsigned)H * W;
  const unsigned plane = (unsigned)B * hw;  // pixels per tap
  if (tid >= plane * groups) return;
  const unsigned g = tid % groups;
  const unsigned pix = tid / groups;  // (b * H + i) * W + j
  const T* img = x + (int64_t)(pix / hw) * hw * C + g * 8;
  T* out = cols + (int64_t)pix * taps * C + g * 8;
  walk_taps(sy, sx, plane, pix, taps, [&](int t, float cy, float cx) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    sample_tap_hoisted(img, cy, cx, H, W, C, acc);
    store8(out + t * C, acc);
  });
}
