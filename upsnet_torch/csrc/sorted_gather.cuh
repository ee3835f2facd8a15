// A counting sort of bilinear samples by their low corner, and the gather
// over the sorted order that sums each source element's gradient in a fixed
// order: the gradient-to-the-map pass of the unclipped all-tap K3
// (deform_sample_bwd.cu, nine tap maps y_t sharing one g) and of K7b
// (deform_sample_mt_bwd.cu, one input x shared by the taps, a g row per
// (pixel, tap)). Each source file wraps the bodies below in kernels of its
// own names, so that a profile tells K3's launches from K7b's.
//
// The samples are a (K, B, H, W) coordinate field: sample
// n = (t * B + b) * H * W + p. A sample counts iff it lies in (-1, H) x
// (-1, W). Its bin is its low corner (y0, x0) in [-1, H - 1] x [-1, W - 1]
// within its plane: a plane per tap and image for K3 (each tap has its own
// map), a plane per image for K7b (the taps read one x, so their bins
// merge). Within a bin the samples are ranked by a key unique in the plane:
// the output pixel p for K3, the item p * K + t for K7b (two taps of one
// pixel may share a bin; with p alone they would tie and take one slot).
// The record of a sample carries its key, and the gather reads g at
// g + image * g_img + key * C: g (B, H, W, C) for K3, (B, H, W, K, C) for
// K7b.
//
// The passes, in device memory: an integer histogram (atomics, so the counts
// are exact), an exclusive scan (per tile of bins, then over the tiles), a
// placement, and a rank pass that writes each sample as a record (key,
// fractional coordinates) at its rank in its bin. Then a thread per
// (plane, source pixel (r, q), 8 * NG channels) sums the 2 x 2 bins whose
// samples reach it with one record load and one g load a sample, and writes
// its element once in the map's dtype: no canvas, no zero fill, no cast, no
// float atomics, the same bits on every run. Scratch: int32, about 4 bytes a
// bin and 24 a sample (work_len).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace sorted_gather {

constexpr int kScanTile = 2048;  // bins a block of the scan owns: 256 threads x 8

// The plane and the key of sample n: MERGED false for K3 (plane t * B + b,
// key p), true for K7b (plane b, key p * K + t).
template <bool MERGED>
__device__ __forceinline__ void plane_key(int64_t n, int K, int B, int64_t hw, int& plane,
                                          int& key) {
  const int tb = (int)(n / hw);  // t * B + b
  const int p = (int)(n % hw);
  plane = MERGED ? tb % B : tb;
  key = MERGED ? p * K + tb / B : p;
}

// The bin of a sample of plane `plane`, keyed by its low corner (y0, x0) in
// [-1, H - 1] x [-1, W - 1], or -1 if it does not count.
__device__ __forceinline__ int sample_bin(float py, float px, int H, int W, int plane) {
  if (!(py > -1.f && py < (float)H && px > -1.f && px < (float)W)) return -1;
  const int y0 = (int)floorf(py), x0 = (int)floorf(px);
  return (plane * (H + 1) + y0 + 1) * (W + 1) + x0 + 1;
}

// Where bin n's samples start in the placed order: its offset within its
// tile plus the tiles before it.
__device__ __forceinline__ int bin_start(const int* offsets, const int* tile_start, int n) {
  return offsets[n] + tile_start[n / kScanTile];
}

// Histogram: counts[bin] += 1 per counted sample, and the sample's slot in
// its bin (the order of the atomics: not yet the final order).
template <bool MERGED>
__device__ __forceinline__ void count_body(const float* __restrict__ sy,
                                           const float* __restrict__ sx,
                                           int* __restrict__ counts, int* __restrict__ slot,
                                           int64_t n_samples, int K, int B, int H, int W) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_samples) return;
  int plane, key;
  plane_key<MERGED>(n, K, B, (int64_t)H * W, plane, key);
  const int bin = sample_bin(__ldg(sy + n), __ldg(sx + n), H, W, plane);
  if (bin >= 0) slot[n] = atomicAdd(counts + bin, 1);
}

// Exclusive scan of each tile of kScanTile bins in place, by 256 threads;
// the tile's total goes to tile_start[tile].
__device__ __forceinline__ void scan_tiles_body(int* __restrict__ counts,
                                                int* __restrict__ tile_start, int n_bins) {
  constexpr int kPer = kScanTile / 256;
  __shared__ int warp_sums[8];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kPer;
  int v[kPer], sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = base + k < n_bins ? counts[base + k] : 0;
    sum += v[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int off = 1; off < 32; off *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  if (threadIdx.x == 255) tile_start[blockIdx.x] = run + sum;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (base + k < n_bins) counts[base + k] = run;
    run += v[k];
  }
}

// Exclusive scan of the n_tiles tile totals in place, by one block of 1024
// threads.
__device__ __forceinline__ void scan_totals_body(int* __restrict__ tile_start, int n_tiles) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < n_tiles; base += 1024) {
    const int k = base + threadIdx.x;
    const int v = k < n_tiles ? tile_start[k] : 0;
    int incl = v;
    for (int off = 1; off < 32; off *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();  // warp_sums written, carry of the last chunk settled
    int run = carry + incl - v;
    for (int w = 0; w < warp; ++w) run += warp_sums[w];
    if (k < n_tiles) tile_start[k] = run;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == 1023) carry = run + v;
  }
}

// Placement: each counted sample's key into its bin at its slot.
template <bool MERGED>
__device__ __forceinline__ void place_body(const float* __restrict__ sy,
                                           const float* __restrict__ sx,
                                           const int* __restrict__ offsets,
                                           const int* __restrict__ tile_start,
                                           const int* __restrict__ slot,
                                           int* __restrict__ placed, int64_t n_samples, int K,
                                           int B, int H, int W) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_samples) return;
  int plane, key;
  plane_key<MERGED>(n, K, B, (int64_t)H * W, plane, key);
  const int bin = sample_bin(__ldg(sy + n), __ldg(sx + n), H, W, plane);
  if (bin >= 0) placed[bin_start(offsets, tile_start, bin) + slot[n]] = key;
}

// Rank: each counted sample into its bin at its rank among the bin's keys,
// so that every bin lists its samples in ascending key, as a record of what
// the gather needs: the key and the fractional parts ly, lx of its
// coordinates.
template <bool MERGED>
__device__ __forceinline__ void rank_body(const float* __restrict__ sy,
                                          const float* __restrict__ sx,
                                          const int* __restrict__ offsets,
                                          const int* __restrict__ tile_start,
                                          const int* __restrict__ placed,
                                          int4* __restrict__ records, int64_t n_samples, int K,
                                          int B, int H, int W) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_samples) return;
  int plane, key;
  plane_key<MERGED>(n, K, B, (int64_t)H * W, plane, key);
  const float py = __ldg(sy + n), px = __ldg(sx + n);
  const int bin = sample_bin(py, px, H, W, plane);
  if (bin < 0) return;
  const int s0 = bin_start(offsets, tile_start, bin);
  const int s1 = bin_start(offsets, tile_start, bin + 1);
  int rank = 0;
  for (int e = s0; e < s1; ++e) rank += placed[e] < key;
  records[s0 + rank] = make_int4(key, __float_as_int(py - floorf(py)),
                                 __float_as_int(px - floorf(px)), 0);
}

// Gather: a thread per (plane, source pixel (r, q), 8 * NG channels) sums
// the samples whose low corner is (r, q), (r, q - 1), (r - 1, q) or
// (r - 1, q - 1): bins (r + 1, q .. q + 1) and (r, q .. q + 1) in the
// (y0 + 1, x0 + 1) numbering, each pair contiguous in the sorted order. Row
// y0 = r first, then r - 1; within a row x0 = q - 1 first, then q; within a
// bin ascending key. One 16-byte record load per sample, then its g at
// g + (plane % B) * g_img + key * C. out (planes, H, W, C).
template <typename T, int NG>
__device__ __forceinline__ void gather_body(const T* __restrict__ g,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ tile_start,
                                            const int4* __restrict__ records,
                                            T* __restrict__ out, int planes, int B, int H, int W,
                                            int C, int64_t g_img) {
  const int slices = C / (8 * NG);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t hw = (int64_t)H * W;
  if (tid >= (int64_t)planes * hw * slices) return;
  const int c0 = (int)(tid % slices) * 8 * NG;
  const int64_t pix = tid / slices;  // (plane * H + r) * W + q
  const int plane = (int)(pix / hw);
  const int r = (int)(pix % hw / W), q = (int)(pix % W);
  const T* g_b = g + (plane % B) * g_img + c0;
  float acc[NG][8];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
  }
#pragma unroll
  for (int dr = 0; dr < 2; ++dr) {
    const int first = (plane * (H + 1) + r + 1 - dr) * (W + 1) + q;  // bin (r - dr, q - 1)
    // [e0, e1) holds bin (r - dr, q - 1), [e1, e2) bin (r - dr, q)
    const int e1 = bin_start(offsets, tile_start, first + 1);
    const int e2 = bin_start(offsets, tile_start, first + 2);
    for (int e = bin_start(offsets, tile_start, first); e < e2; ++e) {
      const int4 rec = __ldg(records + e);
      const float ly = __int_as_float(rec.y), lx = __int_as_float(rec.z);
      const float w = (dr ? ly : 1.f - ly) * (e >= e1 ? 1.f - lx : lx);
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float gv[8];
        load8(g_b + (int64_t)rec.x * C + j * 8, gv);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(w, gv[k], acc[j][k]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) store8(out + pix * C + c0 + j * 8, acc[j]);
}

// The int32 scratch of a sort of n_samples samples into n_bins bins (the
// planes' bins and one more, whose offset is the total), in this order: bin
// offsets, tile starts, one slot per sample, the placed order, then from a
// multiple of 4 one 4-int record per sample.
inline int64_t records_at(int64_t n_bins, int64_t n_samples) {
  const int64_t head = n_bins + (n_bins + kScanTile - 1) / kScanTile + 2 * n_samples;
  return (head + 3) / 4 * 4;
}

inline int64_t work_len(int64_t n_bins, int64_t n_samples) {
  return records_at(n_bins, n_samples) + 4 * n_samples;
}

// The kernels of one sort, each a __global__ wrapper of a body above under
// the name its source file gives it.
struct SortKernels {
  void (*count)(const float*, const float*, int*, int*, int64_t, int, int, int, int);
  void (*scan_tiles)(int*, int*, int);
  void (*scan_totals)(int*, int);
  void (*place)(const float*, const float*, const int*, const int*, const int*, int*, int64_t,
                int, int, int, int);
  void (*rank)(const float*, const float*, const int*, const int*, const int*, int4*, int64_t,
               int, int, int, int);
};

// What the gather reads of a sort, in its scratch.
struct Sorted {
  const int* offsets;
  const int* tile_start;
  const int4* records;
};

// Sorts the K * B * H * W samples of (sy, sx) into `planes` planes of bins
// on stream s, in `work` (work_len long): a zeroed histogram, then the
// kernels of `k` in order. Returns the memset's error code, or 0.
inline int sort_samples(const SortKernels& k, const float* sy, const float* sx, void* work,
                        int K, int B, int H, int W, int planes, Sorted& sorted,
                        cudaStream_t s) {
  const int n_bins = (int)((int64_t)planes * (H + 1) * (W + 1) + 1);
  const int n_tiles = (n_bins + kScanTile - 1) / kScanTile;
  const int64_t n_samples = (int64_t)K * B * H * W;
  int* offsets = static_cast<int*>(work);
  int* tile_start = offsets + n_bins;
  int* slot = tile_start + n_tiles;
  int* placed = slot + n_samples;
  int4* records = reinterpret_cast<int4*>(offsets + records_at(n_bins, n_samples));
  const cudaError_t err = cudaMemsetAsync(offsets, 0, (size_t)n_bins * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_samples + 255) / 256);
  const auto count = k.count;
  const auto scan_tiles = k.scan_tiles;
  const auto scan_totals = k.scan_totals;
  const auto place = k.place;
  const auto rank = k.rank;
  count<<<grid, 256, 0, s>>>(sy, sx, offsets, slot, n_samples, K, B, H, W);
  scan_tiles<<<n_tiles, 256, 0, s>>>(offsets, tile_start, n_bins);
  scan_totals<<<1, 1024, 0, s>>>(tile_start, n_tiles);
  place<<<grid, 256, 0, s>>>(sy, sx, offsets, tile_start, slot, placed, n_samples, K, B, H, W);
  rank<<<grid, 256, 0, s>>>(sy, sx, offsets, tile_start, placed, records, n_samples, K, B, H, W);
  sorted = {offsets, tile_start, records};
  return 0;
}

template <typename T>
using GatherKernel = void (*)(const T*, const int*, const int*, const int4*, T*, int, int, int,
                              int, int, int64_t);

// Launches the gather over `planes` planes of (H, W, C) on stream s: `ng2`
// (16 channels a thread, one record load serving both groups) where C
// allows it, else `ng1`.
template <typename T>
void launch_gather(GatherKernel<T> ng2, GatherKernel<T> ng1, const T* g, const Sorted& sorted,
                   T* out, int planes, int B, int H, int W, int C, int64_t g_img,
                   cudaStream_t s) {
  const int ng = C % 16 == 0 ? 2 : 1;
  const int64_t threads = (int64_t)planes * H * W * (C / (8 * ng));
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  const GatherKernel<T> kernel = ng == 2 ? ng2 : ng1;
  kernel<<<blocks, 256, 0, s>>>(g, sorted.offsets, sorted.tile_start, sorted.records, out,
                                planes, B, H, W, C, g_img);
}

}  // namespace sorted_gather
