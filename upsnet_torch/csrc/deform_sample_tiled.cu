// K6: the deformable bilinear sampler of all taps of a layer read out of the
// side-by-side projection, for maps too wide for the TPU's untiled kernel:
//
//   out[b, i, j, :] = sum_t bilinear(y[b, :, :, t*C:(t+1)*C], sy[t, b, i, j], sx[t, b, i, j]),
//   each tap rounded to y's dtype and added in it in tap order
//
// y (B, H, W, K*C) is one matmul's output with the K tap projections side by
// side; the kernel reads tap t's block in place with pixel stride K*C (no
// per-tap copy, no padding). DCNv1 zero padding on the true H and W: a sample
// counts iff it lies in (-1, H) x (-1, W), and a corner outside the map reads
// zero. Replaces upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_tiled
// (_sample_kernel_tiled), whose grid is (batch, row blocks, column tiles) so
// that each program's VMEM window stays bounded on a wide map, and which
// _deform_conv2d_pallas_tiled calls once per tap and adds in bf16. K6 is that
// loop in one launch (the chain of tap_chain.cuh: the values of the per-tap
// samples added in y's dtype).
//
// The grid here is tiled the same way, (column tiles, row tiles, batch): one
// block per 1 x 32 output pixels. The callers clip the offsets, so a counted
// sample of pixel (i, j) lies within reach_y rows and reach_x columns of it;
// the kernel holds that contract by giving zero to a sample beyond the reach
// (the TPU kernel's window ends there too). A block first stages its tile's
// 2K x 32 coordinates in shared memory with cp.async (2.3 KB at K 9), then
// walks (pixel, 8-channel group) items with the group fastest, so that a
// tap's corner loads of a warp are contiguous per pixel; the taps' partial
// sums stay in registers and the output is written once. The block's
// projection footprint (rows [i0 - reach_y, i0 + reach_y], columns
// [j0 - reach_x, j0 + 32 + reach_x] of every tap, about 60 KB a tap at reach
// 7 and C 128) is not staged: nine of them do not fit shared memory, and the
// blocks in flight share those rows through L2.
//
// Indexing: every offset into y, the coordinates and out is int64_t from a
// per-image base pointer (B*H*W*K*C passes 2^31 elements at batch 8 of a
// 208 x 800 map). Bound by bytes: the touched part of the taps' blocks read
// once, the coordinates, the output written once; 8 flops per element.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample_tap.cuh"
#include "tap_chain.cuh"
#include "vec8.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kBlock = 256;
// output rows of a block: one row keeps the projection rows that the blocks
// in flight read together within L2 (four rows were slower)
constexpr int kTapsTileH = 1;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// K6: sy, sx (K, B, H, W); dynamic shared memory 2 * K * 32 floats.
template <typename T>
__global__ void __launch_bounds__(kBlock)
deform_sample_tiled_taps_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                                const float* __restrict__ sx, T* __restrict__ out,
                                int B, int H, int W, int C, int K,
                                float reach_y, float reach_x) {
  extern __shared__ __align__(16) float coords[];  // [2K][kTapsTileH * kTileW]: sy, sx
  constexpr int kPix = kTapsTileH * kTileW;
  const int groups = C / 8;
  const int stride = K * C;  // elements between neighbouring pixels of y
  const int64_t plane = (int64_t)H * W;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTapsTileH, j0 = blockIdx.x * kTileW;

  // stage the tile's coordinates: chunks of 4 floats along a row, 16-byte
  // copies where a chunk is whole and aligned, 4-byte ones at the edges
  for (int c = threadIdx.x; c < 2 * K * kPix / 4; c += kBlock) {
    const int q = c % (kTileW / 4), r = (c / (kTileW / 4)) % kTapsTileH;
    const int plane_id = c / (kPix / 4);  // tap t of sy, then tap t of sx
    const int t = plane_id % K;
    const int i = i0 + r, j = j0 + 4 * q;
    if (i >= H) continue;
    const float* src = (plane_id < K ? sy : sx) + ((int64_t)t * B + b) * plane
                       + (int64_t)i * W + j;
    float* dst = coords + plane_id * kPix + r * kTileW + 4 * q;
    if (j + 3 < W && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < 4 && j + e < W; ++e) cp_async4(dst + e, src + e);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const T* img = y + (int64_t)b * plane * stride;
  T* out_b = out + (int64_t)b * plane * C;
  for (int item = threadIdx.x; item < kPix * groups; item += kBlock) {
    const int g = item % groups;
    const int p = item / groups;
    const int i = i0 + p / kTileW, j = j0 + p % kTileW;
    if (i >= H || j >= W) continue;
    float res[8];
    for (int t = 0; t < K; ++t) {
      const float py = coords[t * kPix + p], px = coords[(K + t) * kPix + p];
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      if (fabsf(py - (float)i) <= reach_y && fabsf(px - (float)j) <= reach_x) {
        sample_tap_hoisted(img + t * C + g * 8, py, px, H, W, stride, acc);
      }
      chain_add<T>(t, acc, res);
    }
    store8(out_b + ((int64_t)i * W + j) * C + g * 8, res);
  }
}

template <typename T>
void launch_taps(const void* y, const void* sy, const void* sx, void* out, int B, int H,
                 int W, int C, int K, int reach_y, int reach_x, cudaStream_t s) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTapsTileH - 1) / kTapsTileH, B);
  const size_t smem = (size_t)2 * K * kTapsTileH * kTileW * sizeof(float);
  deform_sample_tiled_taps_kernel<T><<<grid, kBlock, smem, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(out), B, H, W, C, K,
      (float)reach_y, (float)reach_x);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. y (B, H, W, K*C); sy, sx (K, B, H, W)
// f32; out (B, H, W, C); B <= 65535, H <= 65535 (grid limits) and
// 2 * K * 32 floats within 48 KB (K <= 192), else the launch fails and its
// error is returned.
int deform_sample_tiled_taps(const void* y, const void* sy, const void* sx, void* out,
                             int B, int H, int W, int C, int K, int reach_y, int reach_x,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && H > 0 && W > 0 && C >= 8 && K > 0) {
    if (dtype == 1) {
      launch_taps<__nv_bfloat16>(y, sy, sx, out, B, H, W, C, K, reach_y, reach_x, s);
    } else {
      launch_taps<float>(y, sy, sx, out, B, H, W, C, K, reach_y, reach_x, s);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
