// K7a: sample-first multi-tap deformable sampling (deformable im2col).
//
//   cols[b, i, j, t, :] = bilinear(x[b], sy[t, b, i, j], sx[t, b, i, j])
//
// The unprojected input x (B, H, W, C) is sampled at all K taps; the conv
// weights follow as one (B*H*W, K*C) x (K*C, Cout) GEMM outside the kernel.
// DCNv1 zero padding: a sample counts iff it lies in (-1, H) x (-1, W), and
// a corner outside the map reads zero. Replaces
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_mt (_sample_mt_kernel),
// which holds a halo window of padded rows in VMEM, builds joint hat
// weights for groups of taps and contracts them on the MXU; its 128-padded
// columns, -1e9 sentinel coordinates and (B, H, K, Wpd, C) output layout are
// the TPU's needs and are not carried over: the columns are written in the
// GEMM's layout directly.
//
// One thread per (pixel, tap, group of 8 channels), the group fastest: each
// corner is one 16-byte load (bf16) or two (f32) along contiguous channels,
// the four corners sum in f32 and the result is rounded once. Any C that is
// a multiple of 8. Bound by bytes: the columns written (K times the input's
// size) dominate; x is read about once through L2. 8 flops per element.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "vec8.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
deform_sample_mt_kernel(const T* __restrict__ x, const float* __restrict__ sy,
                        const float* __restrict__ sx, T* __restrict__ cols,
                        int K, int B, int H, int W, int C) {
  const int groups = C / 8;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * K * groups) return;
  const int g = (int)(tid % groups);
  const int64_t item = tid / groups;  // pix * K + t
  const int t = (int)(item % K);
  const int64_t pix = item / K;  // (b * H + i) * W + j
  const int64_t b = pix / ((int64_t)H * W);
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  sample_tap(x + b * H * W * C + g * 8, __ldg(sy + t * plane + pix),
             __ldg(sx + t * plane + pix), H, W, C, acc);
  store8(cols + item * C + g * 8, acc);
}

template <typename T>
void launch(const void* x, const void* sy, const void* sx, void* cols, int K, int B,
            int H, int W, int C, cudaStream_t s) {
  const int64_t threads = (int64_t)B * H * W * K * (C / 8);
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  deform_sample_mt_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(cols), K, B, H, W, C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, C); sy, sx (K, B, H, W) f32;
// cols (B, H, W, K, C).
int deform_sample_mt(const void* x, const void* sy, const void* sx, void* cols,
                     int K, int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W * K > 0 && C >= 8) {
    if (dtype == 1) launch<__nv_bfloat16>(x, sy, sx, cols, K, B, H, W, C, s);
    else launch<float>(x, sy, sx, cols, K, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
