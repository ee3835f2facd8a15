// K1 and K2: deformable bilinear sampling of tap projections.
//
// K1        out[b, i, j, :] = sum_t bilinear(y9[t, b], sy9[t, b, i, j], sx9[t, b, i, j])
// K2 taps   the same sum, each tap rounded to y's dtype and added in it in
//           tap order: out = tap_0, out = out + tap_1, ...
// K2        out[b, i, j, :] =       bilinear(y[b],     sy[b, i, j],     sx[b, i, j])
//
// DCNv1 zero padding: a sample counts iff it lies in (-1, H) x (-1, W), and a
// corner outside [0, H) x [0, W) reads zero. K1 replaces the TPU kernel
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas9 (_sample9_kernel), the
// inference sampler; K2 replaces _sample_pallas (_sample_kernel), the
// training forward, which _pertap_untiled calls once per tap and adds in
// bf16 (its backward is deform_sample_bwd.cu). The all-tap K2 is the layer's
// training forward in one launch: the chain of tap_chain.cuh, which gives the
// values of the one-tap K2 launched per tap and added in y's dtype. The
// one-tap K2 stays as that chain's yardstick, on no route.
//
// All three: one thread per (output pixel, group of 8 channels): each corner
// is one 16-byte load (bf16) or two (f32) along contiguous channels, and the
// output is stored once. K1 and the one-tap K2 accumulate the taps x 4
// corners in f32 and round once. The all-tap K2 loads a tap's four corners
// before its first FMA and the next tap's coordinates while it is summed,
// and keeps the taps' partial sums in registers. All are bound by the bytes
// of the projections; none needs a halo window or padding.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "tap_chain.cuh"
#include "vec8.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
deform_sample9_kernel(const T* __restrict__ y9, const float* __restrict__ sy9,
                      const float* __restrict__ sx9, T* __restrict__ out,
                      int taps, int B, int H, int W, int C) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int t = 0; t < taps; ++t) {
    sample_tap(y9 + ((int64_t)t * B + b) * H * W * C + g * 8,
               __ldg(sy9 + t * plane + pix), __ldg(sx9 + t * plane + pix), H, W, C, acc);
  }
  store8(out + pix * C + g * 8, acc);
}

// K2: one tap, y (B, H, W, C).
template <typename T>
__global__ void __launch_bounds__(256)
deform_sample_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                     const float* __restrict__ sx, T* __restrict__ out,
                     int B, int H, int W, int C) {
  const int groups = C / 8;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)B * H * W * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  sample_tap(y + (int64_t)b * H * W * C + g * 8, __ldg(sy + pix), __ldg(sx + pix),
             H, W, C, acc);
  store8(out + pix * C + g * 8, acc);
}

// K2, all taps: y (taps, B, H, W, C) tap-major, the chain of tap_chain.cuh
// in registers.
template <typename T>
__global__ void __launch_bounds__(256)
deform_sample_taps_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                          const float* __restrict__ sx, T* __restrict__ out,
                          int taps, int B, int H, int W, int C) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  const T* img = y + (int64_t)b * H * W * C + g * 8;
  float res[8];
  float py = __ldg(sy + pix), px = __ldg(sx + pix);
  for (int t = 0; t < taps; ++t) {
    const float cy = py, cx = px;
    if (t + 1 < taps) {  // in flight while this tap is summed
      py = __ldg(sy + (t + 1) * plane + pix);
      px = __ldg(sx + (t + 1) * plane + pix);
    }
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    sample_tap_hoisted(img + t * plane * C, cy, cx, H, W, C, acc);
    chain_add<T>(t, acc, res);
  }
  store8(out + pix * C + g * 8, res);
}

constexpr int kBlock = 256;

unsigned grid_for(int B, int H, int W, int C) {
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  return (unsigned)((threads + kBlock - 1) / kBlock);
}

template <typename T>
void launch9(const void* y9, const void* sy9, const void* sx9, void* out, int taps,
             int B, int H, int W, int C, cudaStream_t s) {
  deform_sample9_kernel<T><<<grid_for(B, H, W, C), kBlock, 0, s>>>(
      static_cast<const T*>(y9), static_cast<const float*>(sy9),
      static_cast<const float*>(sx9), static_cast<T*>(out), taps, B, H, W, C);
}

template <typename T>
void launch1(const void* y, const void* sy, const void* sx, void* out,
             int B, int H, int W, int C, cudaStream_t s) {
  deform_sample_kernel<T><<<grid_for(B, H, W, C), kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), B, H, W, C);
}

template <typename T>
void launch_taps(const void* y, const void* sy, const void* sx, void* out, int taps,
                 int B, int H, int W, int C, cudaStream_t s) {
  deform_sample_taps_kernel<T><<<grid_for(B, H, W, C), kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), taps, B, H, W, C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers.
// K1: y9 (taps, B, H, W, C), sy9/sx9 (taps, B, H, W) f32, out (B, H, W, C).
int deform_sample9(const void* y9, const void* sy9, const void* sx9, void* out,
                   int taps, int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_for(B, H, W, C) > 0) {
    if (dtype == 1) launch9<__nv_bfloat16>(y9, sy9, sx9, out, taps, B, H, W, C, s);
    else launch9<float>(y9, sy9, sx9, out, taps, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// K2: y (B, H, W, C), sy/sx (B, H, W) f32, out (B, H, W, C).
int deform_sample(const void* y, const void* sy, const void* sx, void* out,
                  int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid_for(B, H, W, C) > 0) {
    if (dtype == 1) launch1<__nv_bfloat16>(y, sy, sx, out, B, H, W, C, s);
    else launch1<float>(y, sy, sx, out, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// K2, all taps: y (taps, B, H, W, C), sy/sx (taps, B, H, W) f32, out
// (B, H, W, C).
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
