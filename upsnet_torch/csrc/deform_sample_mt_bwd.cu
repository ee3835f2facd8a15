// K7b: backward of the sample-first multi-tap sampler (K7a), all K taps in
// one launch.
//
// For cols[b, i, j, t, :] = bilinear(x[b], sy[t, b, i, j], sx[t, b, i, j])
// and g = d loss / d cols (B, H, W, K, C):
//
//   grad_x[b, r, q, :] += vy_r * vx_q * g[b, i, j, t, :]   over all (i, j, t)
//   gsy[t, b, i, j], gsx[t, b, i, j]: the hat derivative -sign(d) on |d| < 1,
//   exactly 0 at an integer coordinate (sample_bwd.cuh)
//
// Replaces upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_mt_bwd
// (_sample_mt_bwd_kernel), which runs per group of 3 taps (a VMEM budget),
// accumulates per-block windows of grad_x in x.dtype and overlap-adds them in
// f32 outside the kernel. Here every tap of every pixel adds into one zeroed
// f32 canvas and the wrapper rounds it once to x.dtype, so in bf16 this is
// the more exact of the two.
//
// Scatter with atomics, as K3, not an adjoint gather as K8b: the gather
// needs a bounded box of candidate output pixels around each source element,
// and here only dy is bounded (the caller clamps it); dx is free, so the box
// would span whole rows. A sub-warp of `width` lanes owns one (pixel, tap);
// taps of a pixel sit in neighbouring sub-warps, so g is read contiguously.
// The K taps of a pixel and its neighbours collide on the same canvas
// elements; the order of the f32 adds is not fixed, so sums differ between
// runs by f32 rounding. Bound by bytes: g (K times the input's size) read
// once, x read, grad_x written.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_bwd.cuh"
#include "vec8.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
deform_sample_mt_bwd_kernel(const T* __restrict__ x, const float* __restrict__ sy,
                            const float* __restrict__ sx, const T* __restrict__ g,
                            float* __restrict__ canvas, float* __restrict__ gsy,
                            float* __restrict__ gsx, int K, int B, int H, int W, int C,
                            int width) {
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t item = tid / width;  // pix * K + t
  const int lane = (int)(tid % width);
  const int t = (int)(item % K);
  const int64_t pix = item / K;  // (b * H + i) * W + j
  const int64_t coord = t * plane + pix;
  float gy = 0.f, gx = 0.f;
  // every lane of the warp reaches the shuffles below, so no early return
  if (pix < plane) {
    const int64_t img_off = pix / ((int64_t)H * W) * H * W * C;
    sample_bwd(x + img_off, canvas + img_off, g + item * C, __ldg(sy + coord),
               __ldg(sx + coord), H, W, C, lane, width, gy, gx);
  }
  for (int off = width / 2; off > 0; off /= 2) {
    gy += __shfl_xor_sync(0xffffffffu, gy, off);
    gx += __shfl_xor_sync(0xffffffffu, gx, off);
  }
  if (lane == 0 && pix < plane) {
    gsy[coord] = gy;
    gsx[coord] = gx;
  }
}

template <typename T>
void launch(const void* x, const void* sy, const void* sx, const void* g, void* canvas,
            void* gsy, void* gsx, int K, int B, int H, int W, int C, cudaStream_t s) {
  const int width = sub_warp_width(C);
  const int block = 256;  // a multiple of every width
  const int64_t threads = (int64_t)B * H * W * K * width;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  deform_sample_mt_bwd_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const T*>(g),
      static_cast<float*>(canvas), static_cast<float*>(gsy), static_cast<float*>(gsx),
      K, B, H, W, C, width);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x and g). x (B, H, W, C); g
// (B, H, W, K, C); sy, sx, gsy, gsx (K, B, H, W) f32; canvas (B, H, W, C)
// f32, zeroed by the caller.
int deform_sample_mt_bwd(const void* x, const void* sy, const void* sx, const void* g,
                         void* canvas, void* gsy, void* gsx, int K, int B, int H, int W,
                         int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W * K > 0 && C >= 8) {
    if (dtype == 1) {
      launch<__nv_bfloat16>(x, sy, sx, g, canvas, gsy, gsx, K, B, H, W, C, s);
    } else {
      launch<float>(x, sy, sx, g, canvas, gsy, gsx, K, B, H, W, C, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
