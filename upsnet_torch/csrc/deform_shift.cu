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
// gradient to y (K8b) is the all-tap K3's row-band gather
// (deform_sample_bwd.cu) on this layout.
//
// The TPU kernels hold a halo window of padded rows in VMEM and loop over
// static (row candidate, column shift) pairs, because a VMEM slab can only be
// shifted by static amounts; here a thread reads the four corners directly
// from the unpadded map, so there is no window, no padding and no candidate
// loop. K8a is K1's function on K1's side-by-side layout, so it runs K1's
// body, sample_taps_pixel (sample_tap.cuh), with the strides of
// side_by_side_strides: image H * W * K * C, tap C, pixel K * C. One
// thread per (output pixel, 8 channels), one launch for all taps; a tap's
// four corner loads are issued before its first FMA and the next tap's
// coordinates are in flight while it is summed; an f32 accumulator over all
// taps and corners, rounded once, so K8a and K1 give the same bits (the
// TPU's K1 adds taps in bf16). K8c: offset_grads_kernel of offset_grads.cuh
// (shared with the coordinate pass of K3) at pixel stride K * C: a sub-warp
// of lanes owns a pixel, a lane a group of 8 channels and its g, a tap's
// four corner loads are issued before any is used, and the lanes' partial
// sums of each tap go through shared memory to one sum in lane order: no
// atomics. Both are bound by the bytes of y: a pixel's record is K * C
// contiguous values, read with 16-byte loads along C.
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

// K8a: K1's body (sample_taps_pixel) on the side-by-side layout; a kernel of
// its own, so that a profile tells the two apart.
template <typename T>
__global__ void __launch_bounds__(kBlock)
shift_fwd_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                 const float* __restrict__ sx, T* __restrict__ out, int K, int B, int H,
                 int W, int C, int64_t img_stride, int64_t tap_stride, int pix_stride) {
  sample_taps_pixel(y, sy, sx, out, (int64_t)blockIdx.x * blockDim.x + threadIdx.x, K, B,
                    H, W, C, img_stride, tap_stride, pix_stride);
}

template <typename T>
void launch_fwd(const void* y, const void* sy, const void* sx, void* out, int K, int B,
                int H, int W, int C, cudaStream_t s) {
  int64_t img, tap, pix;  // side by side: img H * W * K * C, tap C, pixel K * C
  side_by_side_strides(K, H, W, C, img, tap, pix);
  const int64_t threads = (int64_t)B * H * W * (C / 8);
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  shift_fwd_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), K, B, H, W, C, img, tap,
      (int)pix);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of y, out and g). Pointers are device
// pointers. K8a: y (B, H, W, K * C), sy/sx (K, B, H, W) f32, out (B, H, W, C).
int shift_fwd(const void* y, const void* sy, const void* sx, void* out, int K, int B,
              int H, int W, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
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
    int64_t img, tap, pix;  // side by side: img H * W * K * C, tap C, pixel K * C
    side_by_side_strides(K, H, W, C, img, tap, pix);
    const int err = dtype == 1
        ? launch_offset_grads<__nv_bfloat16>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap,
                                             pix, offset_grads::kPallas, nullptr, s)
        : launch_offset_grads<float>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap, pix,
                                     offset_grads::kPallas, nullptr, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
