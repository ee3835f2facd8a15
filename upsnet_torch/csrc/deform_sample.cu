// K1 and K2: deformable bilinear sampling of a layer's tap projections.
//
// K1  out[b, i, j, :] = sum_t bilinear(y_t[b], sy9[t, b, i, j], sx9[t, b, i, j])
// K2  the same sum, each tap rounded to y's dtype and added in it in tap
//     order: out = tap_0, out = out + tap_1, ...
//
// DCNv1 zero padding: a sample counts iff it lies in (-1, H) x (-1, W), and a
// corner outside [0, H) x [0, W) reads zero. K1 replaces the TPU kernel
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas9 (_sample9_kernel), the
// inference sampler; K2 replaces _sample_pallas (_sample_kernel), the
// training forward, which _pertap_untiled calls once per tap and adds in
// bf16 (its backward is deform_sample_bwd.cu). K2 is that loop in one
// launch: the chain of tap_chain.cuh, which gives the values of the per-tap
// samples added in y's dtype.
//
// Both: one thread per (output pixel, group of 8 channels): each corner is
// one 16-byte load (bf16) or two (f32) along contiguous channels, and the
// output is stored once. A tap's four corners are loaded before its first
// FMA (sample_tap_hoisted) and the next tap's coordinates while it is
// summed. K1 accumulates the taps x 4 corners in f32 and rounds once; K2
// keeps the taps' partial sums in registers. Both read the projections side
// by side (B, H, W, K, C), the output of the one (N, Cin) x (Cin, K * C)
// matmul that every route builds, in place through its strides
// (side_by_side_strides). K1's body, sample_taps_pixel (sample_tap.cuh), is
// K8a's (deform_shift.cu) too. Both are bound by the bytes of the
// projections; neither needs a halo window or padding.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "tap_chain.cuh"
#include "vec8.cuh"

namespace {

// K1: y through its side-by-side strides (tap t of image b's pixel p at
// y + b * img_stride + t * tap_stride + p * pix_stride); the body is
// sample_taps_pixel (sample_tap.cuh), which K8a runs too.
template <typename T>
__global__ void __launch_bounds__(256)
deform_sample9_kernel(const T* __restrict__ y, const float* __restrict__ sy9,
                      const float* __restrict__ sx9, T* __restrict__ out,
                      int taps, int B, int H, int W, int C, int64_t img_stride,
                      int64_t tap_stride, int pix_stride) {
  sample_taps_pixel(y, sy9, sx9, out, (int64_t)blockIdx.x * blockDim.x + threadIdx.x, taps,
                    B, H, W, C, img_stride, tap_stride, pix_stride);
}

// K2: y through its side-by-side strides, as K1 reads it; the chain of
// tap_chain.cuh in registers.
template <typename T>
__global__ void __launch_bounds__(256)
deform_sample_taps_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                          const float* __restrict__ sx, T* __restrict__ out,
                          int taps, int B, int H, int W, int C, int64_t img_stride,
                          int64_t tap_stride, int pix_stride) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  const T* img = y + (int64_t)b * img_stride + g * 8;
  float res[8];
  walk_taps(sy, sx, plane, pix, taps, [&](int t, float cy, float cx) {
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    sample_tap_hoisted(img + t * tap_stride, cy, cx, H, W, pix_stride, acc);
    chain_add<T>(t, acc, res);
  });
  store8(out + pix * C + g * 8, res);
}

constexpr int kBlock = 256;

unsigned grid_for(int B, int H, int W, int C) {
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  return (unsigned)((threads + kBlock - 1) / kBlock);
}

template <typename T>
void launch9(const void* y, const void* sy9, const void* sx9, void* out, int taps, int B,
             int H, int W, int C, cudaStream_t s) {
  int64_t img, tap, pix;
  side_by_side_strides(taps, H, W, C, img, tap, pix);
  deform_sample9_kernel<T><<<grid_for(B, H, W, C), kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy9),
      static_cast<const float*>(sx9), static_cast<T*>(out), taps, B, H, W, C, img, tap,
      (int)pix);
}

template <typename T>
void launch_taps(const void* y, const void* sy, const void* sx, void* out, int taps,
                 int B, int H, int W, int C, cudaStream_t s) {
  int64_t img, tap, pix;
  side_by_side_strides(taps, H, W, C, img, tap, pix);
  deform_sample_taps_kernel<T><<<grid_for(B, H, W, C), kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), taps, B, H, W, C, img, tap,
      (int)pix);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers.
// K1: y (B, H, W, taps, C); sy9/sx9 (taps, B, H, W) f32, out (B, H, W, C).
int deform_sample9(const void* y, const void* sy9, const void* sx9, void* out, int taps,
                   int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_for(B, H, W, C) > 0 && taps > 0) {
    if (dtype == 1) launch9<__nv_bfloat16>(y, sy9, sx9, out, taps, B, H, W, C, s);
    else launch9<float>(y, sy9, sx9, out, taps, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// K2: y (B, H, W, taps, C); sy/sx (taps, B, H, W) f32, out (B, H, W, C).
int deform_sample_taps(const void* y, const void* sy, const void* sx, void* out, int taps,
                       int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_for(B, H, W, C) > 0 && taps > 0) {
    if (dtype == 1) launch_taps<__nv_bfloat16>(y, sy, sx, out, taps, B, H, W, C, s);
    else launch_taps<float>(y, sy, sx, out, taps, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
