// K8a and K8c: the fused K-tap sampler of the shift route and its
// coordinate gradients.
//
// y (B, H, W, K * C) holds the K tap projections of one matmul, tap-major
// along the last axis: tap t's block of pixel (r, q) is
// y[b, r, q, t * C .. (t + 1) * C). sy, sx (K, B, H, W) are absolute f32
// sample coordinates. With the hat weights vy_r = max(0, 1 - |sy - r|),
// vx_q = max(0, 1 - |sx - q|) and DCNv1 zero padding (a sample counts iff it
// lies in (-1, H) x (-1, W); rows and columns outside the map read zero):
//
// K8a  out[b, i, j, c]  = sum_t sum_{r, q} vy_r * vx_q * y[b, r, q, t * C + c]
// K8c  gsy[t, b, i, j]  = sum_c g[b, i, j, c] * sum_{r, q} dvy_r *  vx_q * y[b, r, q, t * C + c]
//      gsx[t, b, i, j]  = sum_c g[b, i, j, c] * sum_{r, q}  vy_r * dvx_q * y[b, r, q, t * C + c]
//
// with dv = -sign(d) where |d| < 1, else 0: every derivative is exactly 0 at
// an integer coordinate (d = 0 at the peak, |d| = 1 at its neighbours). They
// replace the TPU kernels upsnet_tpu/ops/deform_shift_pallas.py:_shift_fwd
// (_shift_fwd_kernel) and _shift_offset_grads (_shift_off_kernel). The
// gradient to y is deform_shift_adjoint.cu.
//
// The TPU kernels hold a halo window of padded rows in VMEM and loop over
// static (row candidate, column shift) pairs, because a VMEM slab can only be
// shifted by static amounts; here a thread reads the four corners directly
// from the unpadded map, so there is no window, no padding and no candidate
// loop. K8a: one thread per (output pixel, 8 channels), one launch for all
// taps, an f32 accumulator over all taps and corners, rounded once (K1 adds
// the same way but reads a tap-major stack; the TPU's K1 adds taps in bf16).
// K8c: offset_grads_kernel of offset_grads.cuh (shared with the coordinate
// pass of K3) at pixel stride K * C: a sub-warp of `width` lanes owns a
// pixel, a lane takes groups of 8 channels, and the sub-warp reduces each
// tap's two gradients with shuffles in f32: no atomics. Both are bound by
// the bytes of y: a pixel's record is K * C contiguous values, read with
// 16-byte loads along C.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "offset_grads.cuh"
#include "sample_tap.cuh"
#include "vec8.cuh"

namespace {

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
shift_fwd_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                 const float* __restrict__ sx, T* __restrict__ out,
                 int K, int B, int H, int W, int C) {
  const int groups = C / 8;
  const int KC = K * C;
  const int64_t plane = (int64_t)B * H * W;  // pixels per tap
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= plane * groups) return;
  const int g = (int)(tid % groups);
  const int64_t pix = tid / groups;  // (b * H + i) * W + j
  const int b = (int)(pix / ((int64_t)H * W));
  const T* img = y + (int64_t)b * H * W * KC + g * 8;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int t = 0; t < K; ++t) {
    sample_tap(img + t * C, __ldg(sy + t * plane + pix), __ldg(sx + t * plane + pix),
               H, W, KC, acc);
  }
  store8(out + pix * C + g * 8, acc);
}

template <typename T>
void launch_fwd(const void* y, const void* sy, const void* sx, void* out, int K, int B,
                int H, int W, int C, cudaStream_t s) {
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  shift_fwd_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), K, B, H, W, C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of y, out and g). Pointers are device
// pointers. K8a: y (B, H, W, K * C), sy/sx (K, B, H, W) f32, out (B, H, W, C).
int shift_fwd(const void* y, const void* sy, const void* sx, void* out, int K, int B,
              int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8) {
    if (dtype == 1) launch_fwd<__nv_bfloat16>(y, sy, sx, out, K, B, H, W, C, s);
    else launch_fwd<float>(y, sy, sx, out, K, B, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// K8c: y as above, g (B, H, W, C), gsy/gsx (K, B, H, W) f32, every element
// written.
int shift_offset_grads(const void* y, const void* sy, const void* sx, const void* g,
                       void* gsy, void* gsx, int K, int B, int H, int W, int C,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
    // tap t of pixel (r, q) at ((b * H + r) * W + q) * K * C + t * C
    const int64_t img = (int64_t)H * W * K * C, tap = C, pix = (int64_t)K * C;
    if (dtype == 1) {
      launch_offset_grads<__nv_bfloat16>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap,
                                         pix, s);
    } else {
      launch_offset_grads<float>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap, pix, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
