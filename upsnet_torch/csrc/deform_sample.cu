// K1: summed deformable bilinear sampling of tap-major projections.
//
// out[b, i, j, :] = sum_t bilinear(y9[t, b], sy9[t, b, i, j], sx9[t, b, i, j])
//
// DCNv1 zero padding: a sample counts iff it lies in (-1, H) x (-1, W), and a
// corner outside [0, H) x [0, W) reads zero. Replaces the TPU kernel
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas9 (_sample9_kernel).
//
// One thread per (output pixel, group of 8 channels): each corner is one
// 16-byte load (bf16) or two (f32) along contiguous channels, the 9 taps x 4
// corners accumulate in f32, and the result is rounded once. The work is
// bound by the bytes of y9; the kernel needs no halo window or padding.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void add_corner(const T* img, int yy, int xx, float wgt,
                                           int H, int W, int C, float* acc) {
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return;
  float v[8];
  load8(img + ((int64_t)yy * W + xx) * C, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
}

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
    const float sy = __ldg(sy9 + t * plane + pix);
    const float sx = __ldg(sx9 + t * plane + pix);
    if (!(sy > -1.f && sy < (float)H && sx > -1.f && sx < (float)W)) continue;
    const float fy = floorf(sy), fx = floorf(sx);
    const int y0 = (int)fy, x0 = (int)fx;
    const float ly = sy - fy, lx = sx - fx;
    const float hy = 1.f - ly, hx = 1.f - lx;
    const T* img = y9 + ((int64_t)t * B + b) * H * W * C + g * 8;
    add_corner(img, y0, x0, hy * hx, H, W, C, acc);
    add_corner(img, y0, x0 + 1, hy * lx, H, W, C, acc);
    add_corner(img, y0 + 1, x0, ly * hx, H, W, C, acc);
    add_corner(img, y0 + 1, x0 + 1, ly * lx, H, W, C, acc);
  }
  store8(out + pix * C + g * 8, acc);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers; y9 is
// (taps, B, H, W, C), sy9/sx9 (taps, B, H, W) f32, out (B, H, W, C).
int deform_sample9(const void* y9, const void* sy9, const void* sx9, void* out,
                   int taps, int B, int H, int W, int C, int dtype, void* stream) {
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  const int block = 256;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads > 0) {
    if (dtype == 1) {
      deform_sample9_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(y9), static_cast<const float*>(sy9),
          static_cast<const float*>(sx9), static_cast<__nv_bfloat16*>(out),
          taps, B, H, W, C);
    } else {
      deform_sample9_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(y9), static_cast<const float*>(sy9),
          static_cast<const float*>(sx9), static_cast<float*>(out),
          taps, B, H, W, C);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
