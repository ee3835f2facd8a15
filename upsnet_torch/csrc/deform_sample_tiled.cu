// K6: one tap of the deformable bilinear sampler, read out of the
// side-by-side projection, for maps too wide for the TPU's untiled kernel.
//
//   out[b, i, j, :] = bilinear(y[b, :, :, t*C:(t+1)*C], sy[b, i, j], sx[b, i, j])
//
// y (B, H, W, K*C) is one matmul's output with the K tap projections side by
// side; the kernel reads tap t's block in place with pixel stride K*C (no
// per-tap copy, no padding). DCNv1 zero padding on the true H and W: a sample
// counts iff it lies in (-1, H) x (-1, W), and a corner outside the map reads
// zero. Replaces upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_tiled
// (_sample_kernel_tiled), whose grid is (batch, row blocks, column tiles) so
// that each program's VMEM window stays bounded on a wide map.
//
// The grid here is tiled the same way, (column tiles, row tiles, batch), one
// block per 4 x 32 output pixels. The callers clip the offsets, so a counted
// sample of pixel (i, j) lies within reach_y rows and reach_x columns of it;
// the kernel holds that contract by giving zero to a sample beyond the reach
// (the TPU kernel's window ends there too), so a block reads only the rows
// [i0 - reach_y, i0 + 4 + reach_y] and the columns [j0 - reach_x,
// j0 + 32 + reach_x] of its image: a footprint that fits shared memory, which
// this version does not stage yet. Threads walk (pixel, 8-channel group)
// items with the group fastest, so a warp's 16-byte loads are contiguous.
//
// Indexing: every offset into y, the coordinates and out is int64_t from a
// per-image base pointer (B*H*W*K*C passes 2^31 elements at batch 8 of a
// 208 x 800 map). Bound by bytes: the touched part of the tap's block read
// once, the output written once; 8 flops per element.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "vec8.cuh"

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
deform_sample_tiled_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                           const float* __restrict__ sx, T* __restrict__ out,
                           int H, int W, int C, int K, int t,
                           float reach_y, float reach_x) {
  const int groups = C / 8;
  const int stride = K * C;  // elements between neighbouring pixels of y
  const int64_t plane = (int64_t)H * W;
  const int64_t b = blockIdx.z;
  const T* img = y + b * plane * stride + (int64_t)t * C;
  const float* sy_b = sy + b * plane;
  const float* sx_b = sx + b * plane;
  T* out_b = out + b * plane * C;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int items = kTileH * kTileW * groups;
  for (int item = threadIdx.x; item < items; item += kBlock) {
    const int g = item % groups;
    const int p = item / groups;
    const int i = i0 + p / kTileW, j = j0 + p % kTileW;
    if (i >= H || j >= W) continue;
    const int64_t pix = (int64_t)i * W + j;
    const float py = __ldg(sy_b + pix), px = __ldg(sx_b + pix);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    if (fabsf(py - (float)i) <= reach_y && fabsf(px - (float)j) <= reach_x) {
      sample_tap(img + g * 8, py, px, H, W, stride, acc);
    }
    store8(out_b + pix * C + g * 8, acc);
  }
}

template <typename T>
void launch(const void* y, const void* sy, const void* sx, void* out, int B, int H, int W,
            int C, int K, int t, int reach_y, int reach_x, cudaStream_t s) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  deform_sample_tiled_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), H, W, C, K, t,
      (float)reach_y, (float)reach_x);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. y (B, H, W, K*C); sy, sx (B, H, W) f32;
// out (B, H, W, C); 0 <= t < K; B <= 65535 and H <= 4 * 65535 (grid limits).
int deform_sample_tiled(const void* y, const void* sy, const void* sx, void* out,
                        int B, int H, int W, int C, int K, int t, int reach_y,
                        int reach_x, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0 && W > 0 && C >= 8) {
    if (dtype == 1) {
      launch<__nv_bfloat16>(y, sy, sx, out, B, H, W, C, K, t, reach_y, reach_x, s);
    } else {
      launch<float>(y, sy, sx, out, B, H, W, C, K, t, reach_y, reach_x, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
