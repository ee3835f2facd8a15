// K3: backward of the one-tap deformable bilinear sampler (K2).
//
// For out[b, i, j, :] = sum_{r, q} vy_r * vx_q * y[b, r, q, :] with the hat
// weights vy_r = max(0, 1 - |sy - r|), vx_q = max(0, 1 - |sx - q|) and DCNv1
// zero padding (a sample counts iff it lies in (-1, H) x (-1, W); rows and
// columns outside the map read zero), given g = d loss / d out:
//
//   grad_y[b, r, q, :] += vy_r * vx_q * g[b, i, j, :]            (f32 canvas)
//   gsy[b, i, j] = sum_c g_c * sum_{r, q} dvy_r *  vx_q * y[b, r, q, c]
//   gsx[b, i, j] = sum_c g_c * sum_{r, q}  vy_r * dvx_q * y[b, r, q, c]
//
// with the derivative of the TPU kernel it replaces,
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_bwd
// (_sample_bwd_kernel): dv = -sign(d) where |d| < 1, else 0. At an integer
// coordinate d = 0 at the peak and |d| = 1 at its neighbours, so every
// derivative there is 0.
//
// A sub-warp of `width` lanes (a power of two <= 32, at least C / 8 when
// that fits) owns one pixel; a lane takes groups of 8 channels. It reads g
// and the four corners of y with 16-byte loads, scatters the weighted g into
// the zeroed f32 canvas with vector atomics (neighbouring pixels share
// corners, so the adds collide and their order is not fixed), and the
// sub-warp reduces the two coordinate gradients with shuffles in f32: no
// atomics for those. The work is bound by bytes: y and g read once, the
// canvas written. The per-sample arithmetic is sample_bwd of sample_bwd.cuh,
// shared with K7b (deform_sample_mt_bwd.cu).
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
deform_sample_bwd_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                         const float* __restrict__ sx, const T* __restrict__ g,
                         float* __restrict__ canvas, float* __restrict__ gsy,
                         float* __restrict__ gsx, int B, int H, int W, int C, int width) {
  const int64_t pixels = (int64_t)B * H * W;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t pix = tid / width;  // (b * H + i) * W + j
  const int lane = (int)(tid % width);
  float gy = 0.f, gx = 0.f;
  // every lane of the warp reaches the shuffles below, so no early return
  if (pix < pixels) {
    const int64_t img_off = pix / ((int64_t)H * W) * H * W * C;
    sample_bwd(y + img_off, canvas + img_off, g + pix * C, __ldg(sy + pix),
               __ldg(sx + pix), H, W, C, lane, width, gy, gx);
  }
  for (int off = width / 2; off > 0; off /= 2) {
    gy += __shfl_xor_sync(0xffffffffu, gy, off);
    gx += __shfl_xor_sync(0xffffffffu, gx, off);
  }
  if (lane == 0 && pix < pixels) {
    gsy[pix] = gy;
    gsx[pix] = gx;
  }
}

template <typename T>
void launch(const void* y, const void* sy, const void* sx, const void* g, void* canvas,
            void* gsy, void* gsx, int B, int H, int W, int C, cudaStream_t s) {
  const int width = sub_warp_width(C);
  const int block = 256;  // a multiple of every width
  const int64_t threads = (int64_t)B * H * W * width;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  deform_sample_bwd_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<const T*>(g),
      static_cast<float*>(canvas), static_cast<float*>(gsy), static_cast<float*>(gsx),
      B, H, W, C, width);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of y and g). y, g (B, H, W, C); sy, sx,
// gsy, gsx (B, H, W) f32; canvas (B, H, W, C) f32, zeroed by the caller.
int deform_sample_bwd(const void* y, const void* sy, const void* sx, const void* g,
                      void* canvas, void* gsy, void* gsx, int B, int H, int W, int C,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8) {
    if (dtype == 1) {
      launch<__nv_bfloat16>(y, sy, sx, g, canvas, gsy, gsx, B, H, W, C, s);
    } else {
      launch<float>(y, sy, sx, g, canvas, gsy, gsx, B, H, W, C, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
