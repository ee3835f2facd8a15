// K7b: backward of the sample-first multi-tap sampler (K7a), all K taps.
//
// For cols[b, i, j, t, :] = bilinear(x[b], sy[t, b, i, j], sx[t, b, i, j])
// and g = d loss / d cols (B, H, W, K, C):
//
//   grad_x[b, r, q, :] = sum over (i, j, t) of vy_r * vx_q * g[b, i, j, t, :]
//   gsy[t, b, i, j] = sum_c g[b, i, j, t, c] * sum_{r, q} dvy_r *  vx_q * x[b, r, q, c]
//   gsx[t, b, i, j] = sum_c g[b, i, j, t, c] * sum_{r, q}  vy_r * dvx_q * x[b, r, q, c]
//
// with the hat weights v = max(0, 1 - |d|), dv = -sign(d) where |d| < 1 and
// 0 elsewhere (exactly 0 at an integer coordinate), DCNv1 zero padding.
// Replaces upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_mt_bwd
// (_sample_mt_bwd_kernel), which runs per group of 3 taps (a VMEM budget),
// accumulates per-block windows of grad_x in x.dtype in a fixed sequence of
// grid steps and overlap-adds them in f32 outside the kernel.
//
// It is the unclipped all-tap K3 with the roles of the taps turned round:
// there nine tap maps share one g, here one x is shared by the taps and
// each (pixel, tap) has its own g row. So it runs K3's two passes:
//  (a) grad_x by the counting sort and gather of sorted_gather.cuh, with
//      the bins of all K taps of an image merged into one plane (dx is
//      unbounded, so no row band or box bounds the samples that reach a
//      source pixel) and each bin ranked by the (pixel, tap) item
//      p * K + t, unique in the image. A thread per (source pixel, 16
//      channels) sums its 2 x 2 bins in f32 registers in a fixed order and
//      writes grad_x once in x's dtype: no canvas, no zero fill, no cast,
//      no float atomics, the same bits on every run;
//  (b) gsy and gsx by the coordinate pass of offset_grads.cuh, with x as
//      every tap's map (tap stride 0) and g read per (pixel, tap).
// The kernels carry names of their own (mt_bwd_*), so that a profile tells
// them from K3's. Bound by bytes: g (K times x's size) is read by both
// passes, by the gather once per corner through L1/L2; x, the coordinates,
// grad_x and the coordinate gradients once each. Scratch: int32, about 4
// bytes a bin and 24 a sample (sorted_gather::work_len).
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "offset_grads.cuh"
#include "sorted_gather.cuh"
#include "vec8.cuh"

namespace {

__global__ void __launch_bounds__(256)
mt_bwd_count_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
                    int* __restrict__ counts, int* __restrict__ slot, int64_t n_samples, int K,
                    int B, int H, int W) {
  sorted_gather::count_body<true>(sy, sx, counts, slot, n_samples, K, B, H, W);
}

__global__ void __launch_bounds__(256)
mt_bwd_scan_tiles_kernel(int* __restrict__ counts, int* __restrict__ tile_start, int n_bins) {
  sorted_gather::scan_tiles_body(counts, tile_start, n_bins);
}

__global__ void __launch_bounds__(1024) mt_bwd_scan_totals_kernel(int* __restrict__ tile_start,
                                                                  int n_tiles) {
  sorted_gather::scan_totals_body(tile_start, n_tiles);
}

__global__ void __launch_bounds__(256)
mt_bwd_place_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
                    const int* __restrict__ offsets, const int* __restrict__ tile_start,
                    const int* __restrict__ slot, int* __restrict__ placed, int64_t n_samples,
                    int K, int B, int H, int W) {
  sorted_gather::place_body<true>(sy, sx, offsets, tile_start, slot, placed, n_samples, K, B, H,
                                  W);
}

__global__ void __launch_bounds__(256)
mt_bwd_rank_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
                   const int* __restrict__ offsets, const int* __restrict__ tile_start,
                   const int* __restrict__ placed, int4* __restrict__ records,
                   int64_t n_samples, int K, int B, int H, int W) {
  sorted_gather::rank_body<true>(sy, sx, offsets, tile_start, placed, records, n_samples, K, B,
                                 H, W);
}

// grad_x (B, H, W, C): plane b, g (B, H, W, K, C) read at image b, item
// p * K + t.
template <typename T, int NG>
__global__ void __launch_bounds__(256)
mt_bwd_gather_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                     const int* __restrict__ tile_start, const int4* __restrict__ records,
                     T* __restrict__ gx, int planes, int B, int H, int W, int C,
                     int64_t g_img) {
  sorted_gather::gather_body<T, NG>(g, offsets, tile_start, records, gx, planes, B, H, W, C,
                                    g_img);
}

template <typename T, int WIDTH>
__global__ void __launch_bounds__(offset_grads::kBlock)
mt_bwd_coords_kernel(const T* __restrict__ x, const float* __restrict__ sy,
                     const float* __restrict__ sx, const T* __restrict__ g,
                     float* __restrict__ gsy, float* __restrict__ gsx, int K, int B, int H,
                     int W, int C) {
  offset_grads::body<T, WIDTH, true>(x, sy, sx, g, gsy, gsx, K, B, H, W, C, (int64_t)H * W * C,
                                     0, C, C, (int64_t)K * C);
}

int64_t mt_work(int K, int B, int H, int W) {
  return sorted_gather::work_len((int64_t)B * (H + 1) * (W + 1) + 1, (int64_t)K * B * H * W);
}

template <typename T>
int launch(const void* x, const void* sy, const void* sx, const void* g, void* gx, void* gsy,
           void* gsx, void* work, int K, int B, int H, int W, int C, cudaStream_t s) {
  const sorted_gather::SortKernels kernels{mt_bwd_count_kernel, mt_bwd_scan_tiles_kernel,
                                           mt_bwd_scan_totals_kernel, mt_bwd_place_kernel,
                                           mt_bwd_rank_kernel};
  const float* fy = static_cast<const float*>(sy);
  const float* fx = static_cast<const float*>(sx);
  const T* tg = static_cast<const T*>(g);
  sorted_gather::Sorted sorted;
  const int err = sorted_gather::sort_samples(kernels, fy, fx, work, K, B, H, W, B, sorted, s);
  if (err != 0) return err;
  sorted_gather::launch_gather<T>(mt_bwd_gather_kernel<T, 2>, mt_bwd_gather_kernel<T, 1>, tg,
                                  sorted, static_cast<T*>(gx), B, B, H, W, C,
                                  (int64_t)H * W * K * C, s);
  with_width(C, [&](auto width) {
    constexpr int WIDTH = decltype(width)::value;
    mt_bwd_coords_kernel<T, WIDTH>
        <<<offset_grads::grid(B, H, W, WIDTH), offset_grads::kBlock, 0, s>>>(
            static_cast<const T*>(x), fy, fx, tg, static_cast<float*>(gsy),
            static_cast<float*>(gsx), K, B, H, W, C);
  });
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x, g and gx). x, gx (B, H, W, C); g
// (B, H, W, K, C); sy, sx, gsy, gsx (K, B, H, W) f32, every element of gx,
// gsy and gsx written; work int32 scratch of `work_len` elements, at least
// mt_work(K, B, H, W) (else cudaErrorInvalidValue), below 2^31.
int deform_sample_mt_bwd(const void* x, const void* sy, const void* sx, const void* g,
                         void* gx, void* gsy, void* gsx, void* work, int K, int B, int H,
                         int W, int C, int work_len, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W * K > 0 && C >= 8) {
    if (work_len < mt_work(K, B, H, W)) return (int)cudaErrorInvalidValue;
    const int err = dtype == 1
        ? launch<__nv_bfloat16>(x, sy, sx, g, gx, gsy, gsx, work, K, B, H, W, C, s)
        : launch<float>(x, sy, sx, g, gx, gsy, gsx, work, K, B, H, W, C, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
