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
// One thread per (pixel, group of 8 channels), the group fastest, over a
// 32-bit index (the wrapper refuses calls of 2^31 threads or more): the
// thread walks the K taps of its pixel as K1 does (sample_each_tap_pixel of
// sample_tap.cuh), the next tap's coordinates in flight, a tap's four corner
// loads (16 bytes each in bf16, two in f32, along contiguous channels)
// issued before its first FMA, and each tap summed in f32 from zero and
// rounded once into its 8 columns. The same sums in the same corner order
// as the one-thread-a-tap design before it, so the same bits. Any C that is
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
                        const float* __restrict__ sx, T* __restrict__ cols, int K, int B, int H,
                        int W, int C) {
  sample_each_tap_pixel(x, sy, sx, cols, blockIdx.x * blockDim.x + threadIdx.x, K, B, H, W, C);
}

template <typename T>
void launch(const void* x, const void* sy, const void* sx, void* cols, int K, int B, int H,
            int W, int C, cudaStream_t s) {
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  deform_sample_mt_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(cols), K, B, H, W, C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x (B, H, W, C); sy, sx (K, B, H, W) f32;
// cols (B, H, W, K, C). B * H * W * C / 8 < 2^31 (else cudaErrorInvalidValue).
int deform_sample_mt(const void* x, const void* sy, const void* sx, void* cols,
                     int K, int B, int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W * K > 0 && C >= 8) {
    if ((int64_t)B * H * W * (C / 8) >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
    if (dtype == 1) launch<__nv_bfloat16>(x, sy, sx, cols, K, B, H, W, C, s);
    else launch<float>(x, sy, sx, cols, K, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
