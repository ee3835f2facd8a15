// K3: backward of the deformable bilinear sampler for all taps of a layer,
// in two forms: where dy is clipped (the row-band gather) and where nothing
// is clipped (a counting sort and a gather).
//
// For out[b, i, j, :] = sum_t sum_{r, q} vy_r * vx_q * y_t[b, r, q, :] with
// the hat weights vy_r = max(0, 1 - |sy_t - r|), vx_q = max(0, 1 - |sx_t - q|)
// and DCNv1 zero padding (a sample counts iff it lies in (-1, H) x (-1, W);
// rows and columns outside the map read zero), given g = d loss / d out:
//
//   grad_y_t[b, r, q, :] = sum_{i, j} vy_r * vx_q * g[b, i, j, :]
//   gsy[t, b, i, j] = sum_c g_c * sum_{r, q} dvy_r *  vx_q * y_t[b, r, q, c]
//   gsx[t, b, i, j] = sum_c g_c * sum_{r, q}  vy_r * dvx_q * y_t[b, r, q, c]
//
// where dv, the derivative of a node's hat weight, is that of the JAX function
// the caller's route stands for (offset_grads.cuh names the three rules): by
// default that of the TPU kernel this replaces,
// upsnet_tpu/ops/deform_conv_pallas.py:_sample_pallas_bwd
// (_sample_bwd_kernel), dv = -sign(d) where |d| < 1, else 0, which is 0 at
// an integer coordinate.
//
// The TPU kernel read-modify-writes a window of an f32 canvas in a fixed
// sequence of grid steps, so its sums come out the same on every run. Blocks
// here run in no order, so both forms gather instead: each grad_y
// element is summed in f32 registers over its contributing samples in a
// fixed order (ascending output pixel within each low-corner bucket) and
// written once in y's dtype. No canvas, no zero fill, no cast, no float
// atomics, and the same bits on every run. Their coordinate pass is
// offset_grads_kernel (offset_grads.cuh, shared with K8c), which needs no
// reach. Both are bound by bytes: y, g and the coordinates read once,
// grad_y and the coordinate gradients written once; the gathers read g once
// per corner, from L1/L2.
//
// Dy clipped (deform_sample_bwd_taps_grad_y; also K8b, the shift
// route's gradient to its projections): every counted sample of pixel
// (i, j) lies within `reach` rows of i, so canvas row r receives only from
// the output rows [r - reach - 1, r + reach]; dx is free. A block owns 2
// full-width rows of one tap's grad_y of one image for 128 channels. It
// buckets the samples of the rows that can reach the band by their low
// corner column (integer shared-memory atomics: shared-memory float atomics
// are compare-and-swap loops on this card), orders each bucket by output
// pixel, then a thread per (column, 8 channels) sums the two buckets that
// reach its column and writes the band once, in y's side-by-side layout
// (B, H, W, K, C): a warp writes whole runs of channels. The taps are a grid
// dimension, not a loop in the block, so that blocks of different taps
// overlap their phases. A counted sample
// beyond the reach gets no gradient to y (the callers' clip rules it out).
//
// Nothing clipped (deform_sample_bwd_unclipped_grad_y: `auto`,
// `gather`): a sample may lie anywhere, so there is no band. A counting sort
// of all samples by their low corner (y0, x0) in [-1, H - 1] x [-1, W - 1],
// per tap and image, in device memory: an integer histogram (atomics, so the
// counts are exact), an exclusive scan (per tile of bins, then over the
// tiles), a placement, and a rank pass that orders each bin by output pixel.
// The rank pass writes each sample as a record (output pixel, fractional
// coordinates), so that a thread per (source pixel, 16 channels) sums the
// 2 x 2 bins whose samples reach it with one record load and one g load a
// sample, and writes grad_y once, side by side through its strides, as the
// band gather. Scratch: about 4 bytes per bin and 24 per sample. The passes are the bodies of sorted_gather.cuh,
// which K7b (deform_sample_mt_bwd.cu) runs under kernel names of its own.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "offset_grads.cuh"
#include "sample_tap.cuh"
#include "sorted_gather.cuh"
#include "vec8.cuh"

namespace {

constexpr int kBandRows = 2;      // grad_y rows a block owns
constexpr int kSliceGroups = 16;  // 8-channel groups a block owns (128 channels)

// The low corner column of pixel p's sample if it counts, lies within
// `reach` rows of the pixel's row and one of its two corner rows falls in
// [r0, r0 + rows); else -2.
__device__ __forceinline__ int band_column(const float* sy, const float* sx, int p, int H,
                                           int W, int r0, int rows, float reach) {
  const float py = __ldg(sy + p), px = __ldg(sx + p);
  if (!(py > -1.f && py < (float)H && px > -1.f && px < (float)W)) return -2;
  if (fabsf(py - (float)(p / W)) > reach) return -2;  // beyond the reach: no gradient
  const int y0 = (int)floorf(py);
  if (y0 + 1 < r0 || y0 >= r0 + rows) return -2;
  return (int)floorf(px);
}

// out[0..n] = the exclusive prefix sums of in[0..n), out[n] the total.
__device__ void exclusive_scan(const int* in, int* out, int n, int* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += in[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int k = lo; k < hi; ++k) {
    out[k] = run;
    run += in[k];
  }
  if (threadIdx.x == blockDim.x - 1) out[n] = run;
}

// One block: grad_y rows [kBandRows * blockIdx.y, + kBandRows) of tap
// blockIdx.z % K of image blockIdx.z / K for channel groups
// [kSliceGroups * blockIdx.x, + kSliceGroups). The samples of the output
// rows that can reach the band and do are bucketed by their low corner
// column (a histogram that also keeps each pixel's column, a prefix sum and
// a placement, with integer shared-memory atomics). The placement's order
// follows the atomics, so a rank pass then copies each bucket in ascending
// scanned-pixel order. A thread per (column q, channel group) gathers
// buckets q (corner x0, weight hx) and q - 1 (corner x0 + 1, weight lx) in
// that order into f32 registers for the band's rows and writes them once.
template <typename T>
__global__ void __launch_bounds__(256)
grad_y_gather_kernel(const T* __restrict__ g, const float* __restrict__ sy,
                     const float* __restrict__ sx, T* __restrict__ gy, int K, int B, int H,
                     int W, int C, int reach, int64_t img_stride, int64_t tap_stride,
                     int64_t pix_stride) {
  extern __shared__ int smem[];
  int* start = smem;            // [W + 2]: bucket x0 + 1 holds [start[x0 + 1], start[x0 + 2])
  int* cursor = start + W + 2;  // [W + 1]: counts, then placement cursors
  // per scanned pixel: its column x0 (or -2), and the entries by bucket
  // (pixels as offsets from the first scanned one)
  short* column = reinterpret_cast<short*>(cursor + W + 1);
  __shared__ int warp_sums[32];
  const int g0 = blockIdx.x * kSliceGroups;
  const int r0 = blockIdx.y * kBandRows;
  const int b = blockIdx.z / K, t = blockIdx.z % K;
  const int rows = min(kBandRows, H - r0);
  const int ng = min(kSliceGroups, C / 8 - g0);
  // the output rows whose samples can reach a row of the band
  const int i_lo = max(0, r0 - reach - 1), i_hi = min(H - 1, r0 + rows - 1 + reach);
  const int p_lo = i_lo * W, n_scan = (i_hi + 1) * W - p_lo;
  unsigned short* entries = reinterpret_cast<unsigned short*>(column + n_scan);
  const int64_t plane = (int64_t)B * H * W;
  const int64_t img_pix = (int64_t)b * H * W;
  const T* g_b = g + img_pix * C;
  const float fr = (float)reach;
  {
    const float* sy_t = sy + t * plane + img_pix;
    const float* sx_t = sx + t * plane + img_pix;
    for (int k = threadIdx.x; k <= W; k += blockDim.x) cursor[k] = 0;
    __syncthreads();
    for (int k = threadIdx.x; k < n_scan; k += blockDim.x) {
      const int x0 = band_column(sy_t, sx_t, p_lo + k, H, W, r0, rows, fr);
      column[k] = (short)x0;
      if (x0 >= -1) atomicAdd(cursor + x0 + 1, 1);
    }
    __syncthreads();
    exclusive_scan(cursor, start, W + 1, warp_sums);
    __syncthreads();
    for (int k = threadIdx.x; k <= W; k += blockDim.x) cursor[k] = start[k];
    __syncthreads();
    for (int k = threadIdx.x; k < n_scan; k += blockDim.x) {
      const int x0 = column[k];
      if (x0 >= -1) entries[atomicAdd(cursor + x0 + 1, 1)] = (unsigned short)k;
    }
    __syncthreads();
    // the columns are read: their space takes each bucket's entries in order
    unsigned short* sorted = reinterpret_cast<unsigned short*>(column);
    for (int e = threadIdx.x; e < start[W + 1]; e += blockDim.x) {
      int lo = 0, hi = W + 1;  // start[lo] <= e < start[hi]: find e's bucket
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (start[mid] <= e) lo = mid; else hi = mid;
      }
      const unsigned short k = entries[e];
      int rank = 0;
      for (int f = start[lo]; f < start[lo + 1]; ++f) rank += entries[f] < k;
      sorted[start[lo] + rank] = k;
    }
    __syncthreads();
    T* out = gy + (int64_t)b * img_stride + t * tap_stride;
    for (int it = threadIdx.x; it < W * ng; it += blockDim.x) {
      const int q = it / ng, grp = g0 + it % ng;
      float acc[kBandRows][8];
#pragma unroll
      for (int rr = 0; rr < kBandRows; ++rr) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[rr][k] = 0.f;
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {  // x0 == q, then x0 == q - 1
        const int bucket = q + 1 - side;
        for (int e = start[bucket]; e < start[bucket + 1]; ++e) {
          const int p = p_lo + sorted[e];
          const float py = __ldg(sy_t + p), px = __ldg(sx_t + p);
          const float fy = floorf(py), fx = floorf(px);
          const float ly = py - fy, lx = px - fx;
          const float vx = side ? lx : 1.f - lx;
          const int y0 = (int)fy - r0;
          float gv[8];
          load8(g_b + (int64_t)p * C + grp * 8, gv);
#pragma unroll
          for (int rr = 0; rr < kBandRows; ++rr) {
            const float vy = y0 == rr ? 1.f - ly : (y0 + 1 == rr ? ly : 0.f);
            const float w = vy * vx;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[rr][k] = fmaf(w, gv[k], acc[rr][k]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kBandRows; ++rr) {
        if (rr < rows) {
          store8(out + ((int64_t)(r0 + rr) * W + q) * pix_stride + grp * 8, acc[rr]);
        }
      }
    }
  }
}

// Shared memory of grad_y_gather_kernel: the bucket bounds and cursors, and
// a column and an entry for each pixel of the rows a band scans.
size_t gather_bytes(int W, int reach) {
  return (size_t)(2 * W + 3) * sizeof(int)
         + (size_t)(kBandRows + 2 * reach + 1) * W * (sizeof(short) + sizeof(unsigned short));
}

template <typename T>
int launch_grad_y(const void* g, const void* sy, const void* sx, void* gy, int K, int B,
                  int H, int W, int C, int reach, cudaStream_t s) {
  int64_t img, tap, pix;
  side_by_side_strides(K, H, W, C, img, tap, pix);
  // the limit is raised only when a launch needs more than the last one
  // raised it to: a cudaFuncSetAttribute call on every launch leaves the card idle
  static size_t raised = 0;
  const size_t bytes = gather_bytes(W, reach);
  if (bytes > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        grad_y_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    raised = bytes;
  }
  const dim3 grid((C / 8 + kSliceGroups - 1) / kSliceGroups, (H + kBandRows - 1) / kBandRows,
                  B * K);
  grad_y_gather_kernel<T><<<grid, 256, bytes, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(gy), K, B, H, W, C, reach, img, tap,
      pix);
  return (int)cudaGetLastError();
}


// ---- nothing clipped: a counting sort of the samples, a gather ----
// (sorted_gather.cuh, shared with K7b; K3's planes are (tap, image), its keys
// output pixels)

__global__ void __launch_bounds__(256)
bin_count_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
                 int* __restrict__ counts, int* __restrict__ slot, int64_t n_samples, int K,
                 int B, int H, int W) {
  sorted_gather::count_body<false>(sy, sx, counts, slot, n_samples, K, B, H, W);
}

__global__ void __launch_bounds__(256)
scan_tiles_kernel(int* __restrict__ counts, int* __restrict__ tile_start, int n_bins) {
  sorted_gather::scan_tiles_body(counts, tile_start, n_bins);
}

__global__ void __launch_bounds__(1024) scan_totals_kernel(int* __restrict__ tile_start,
                                                           int n_tiles) {
  sorted_gather::scan_totals_body(tile_start, n_tiles);
}

__global__ void __launch_bounds__(256)
place_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
             const int* __restrict__ offsets, const int* __restrict__ tile_start,
             const int* __restrict__ slot, int* __restrict__ placed, int64_t n_samples, int K,
             int B, int H, int W) {
  sorted_gather::place_body<false>(sy, sx, offsets, tile_start, slot, placed, n_samples, K, B,
                                   H, W);
}

__global__ void __launch_bounds__(256)
rank_kernel(const float* __restrict__ sy, const float* __restrict__ sx,
            const int* __restrict__ offsets, const int* __restrict__ tile_start,
            const int* __restrict__ placed, int4* __restrict__ records, int64_t n_samples,
            int K, int B, int H, int W) {
  sorted_gather::rank_body<false>(sy, sx, offsets, tile_start, placed, records, n_samples, K,
                                  B, H, W);
}

// grad_y side by side (side_by_side_strides): plane t * B + b, g (B, H, W, C)
// read at image b, key p.
template <typename T, int NG>
__global__ void __launch_bounds__(256)
grad_y_sorted_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                     const int* __restrict__ tile_start, const int4* __restrict__ records,
                     T* __restrict__ gy, int planes, int B, int H, int W, int C, int64_t g_img,
                     int64_t gy_img, int64_t gy_tap, int64_t gy_pix) {
  sorted_gather::gather_body<T, NG>(g, offsets, tile_start, records, gy, planes, B, H, W, C,
                                    g_img, gy_img, gy_tap, gy_pix);
}

int64_t unclipped_work(int K, int B, int H, int W) {
  return sorted_gather::work_len((int64_t)K * B * (H + 1) * (W + 1) + 1, (int64_t)K * B * H * W);
}

template <typename T>
int launch_grad_y_unclipped(const void* g, const void* sy, const void* sx, void* gy,
                            void* work, int K, int B, int H, int W, int C, cudaStream_t s) {
  const sorted_gather::SortKernels kernels{bin_count_kernel, scan_tiles_kernel,
                                           scan_totals_kernel, place_kernel, rank_kernel};
  sorted_gather::Sorted sorted;
  const int err = sorted_gather::sort_samples(kernels, static_cast<const float*>(sy),
                                              static_cast<const float*>(sx), work, K, B, H, W,
                                              K * B, sorted, s);
  if (err != 0) return err;
  int64_t img, tap, pix;
  side_by_side_strides(K, H, W, C, img, tap, pix);
  sorted_gather::launch_gather<T>(grad_y_sorted_kernel<T, 2>, grad_y_sorted_kernel<T, 1>,
                                  static_cast<const T*>(g), sorted, static_cast<T*>(gy), K * B,
                                  B, H, W, C, (int64_t)H * W * C, img, tap, pix, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dy clipped, pass 1. dtype: 0 = float32, 1 = bfloat16 (of g and gy). g
// (B, H, W, C); sy, sx (K, B, H, W) f32 with |sy - i| <= reach at every
// counted sample of pixel (i, j); gy (B, H, W, K, C), every element
// written. B * K <= 65535 and gather_bytes(W, reach) within the 232448 bytes
// of shared memory a block can use (so a band's scanned pixels fit their
// 16-bit numbers).
int deform_sample_bwd_taps_grad_y(const void* g, const void* sy, const void* sx, void* gy,
                                  int K, int B, int H, int W, int C, int reach,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
    const int err = dtype == 1
        ? launch_grad_y<__nv_bfloat16>(g, sy, sx, gy, K, B, H, W, C, reach, s)
        : launch_grad_y<float>(g, sy, sx, gy, K, B, H, W, C, reach, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// Nothing clipped, pass 1. dtype: 0 = float32, 1 = bfloat16 (of g and gy).
// g (B, H, W, C); sy, sx (K, B, H, W) f32, any values; gy (B, H, W, K, C),
// every element written; work int32 scratch of `work_len` elements, at least
// unclipped_work(K, B, H, W) (else cudaErrorInvalidValue), with
// K * B * (H + 1) * (W + 1) < 2^31.
int deform_sample_bwd_unclipped_grad_y(const void* g, const void* sy, const void* sx,
                                       void* gy, void* work, int K, int B, int H, int W,
                                       int C, int work_len, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
    if (work_len < unclipped_work(K, B, H, W)) return (int)cudaErrorInvalidValue;
    const int err = dtype == 1
        ? launch_grad_y_unclipped<__nv_bfloat16>(g, sy, sx, gy, work, K, B, H, W, C, s)
        : launch_grad_y_unclipped<float>(g, sy, sx, gy, work, K, B, H, W, C, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

// Pass 2 (both forms): gsy, gsx (K, B, H, W) f32, every element written;
// y (B, H, W, K, C), g (B, H, W, C); rule 0 (kPallas), 1 (kHat) or 2
// (kFloor), else cudaErrorInvalidValue; fast null, or a device byte: where
// it reads 0, kFloor instead of rule (`auto`).
int deform_sample_bwd_taps_coords(const void* y, const void* sy, const void* sx,
                                  const void* g, void* gsy, void* gsx, const void* fast, int K,
                                  int B, int H, int W, int C, int rule, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
    int64_t img, tap, pix;
    side_by_side_strides(K, H, W, C, img, tap, pix);
    const int err = dtype == 1
        ? launch_offset_grads<__nv_bfloat16>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap,
                                             pix, rule, fast, s)
        : launch_offset_grads<float>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img, tap, pix,
                                     rule, fast, s);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
