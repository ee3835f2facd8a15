// K5: backward of the FPN ROIAlign forward (K4) to the four level maps.
//
// The forward averages the S x S bilinear samples of each bin, so the
// gradient of bin (ph, pw) of RoI (b, r), divided by S * S, goes to each of
// its samples and from there to the sample's four corners with the
// forward's weights and Detectron clamps (samples outside [-1, H] x [-1, W]
// count zero, coordinates clamp below at 0 and snap to the last row or
// column). RoIs and levels get no gradient. Replaces the TPU kernel
// upsnet_tpu/ops/roi_align_pallas.py:fpn_roi_align_window_bwd
// (_window_bwd_kernel), which read-modify-writes a per-RoI window of an f32
// canvas in sequential grid steps.
//
// Here the scatter becomes a gather over tiles of the output. One launch
// covers all four levels and all images: a block owns an 8 x 8 tile of one
// level of one image for 128 channels. It keeps, in RoI order, the RoIs of
// its image assigned to its level whose sample footprint (the box at the
// level's scale, widened by one cell) meets the tile, and drops those whose
// gradient is zero in all of its channels: the padded slots, which share
// one box and so pile up on one tile by the hundred. A warp tests one RoI,
// kLoads groups of 8 values a lane in flight, on their bits, and stops at
// the first non-zero value, so a live RoI costs one round and a padded one
// a read of its slice (loads converted to float behind a branch were issued
// one at a time: a tile of a hundred padded slots took most of a call). A
// sample's weight is separable, wy * wx, and the samples lie on a regular
// P*S x P*S grid, so for the live RoIs (eight at a time) the block
// tabulates in shared memory the weight of each bin on each tile row,
// By[r][ph] = sum over the bin's S sample rows of hy [yl == r] +
// ly [yh == r] (zero for a sample outside [-1, H]), the same for the
// columns, Bx[q][pw], and the first and last bin with a weight on each row
// and column. A thread then adds
// By[r][ph] * Bx[q][pw] * g[roi, ph, pw, c] over those bins to an f32
// register accumulator for its pixels and 8 channels; a bin whose 8 values
// are zero adds nothing after its load. Each output element is written
// once, divided by S * S and rounded to the level's dtype: no canvas, no
// zero fill, no cast, no atomics, and every sum is taken in a fixed order,
// so runs are bit-identical. A tile that no RoI reaches is written with
// zeros. Bound by bytes: the pyramid's gradient written once, g (up to
// 25.7 MB a call, re-read from L2 by overlapping tiles), the RoIs and
// levels. A block that owned a strip of four tiles, to share the RoI tests,
// was slower: more registers, fewer blocks resident.
//
// Sample coordinates round exactly as in roi_align_fpn.cu (the extent times
// the float32 reciprocal of P, then one fused multiply-add), so every sample
// lands on the forward's corners with the forward's weights.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

constexpr int kTile = 8;                                // tile rows and columns
constexpr int kGroups = 16;                             // 8-channel groups a block owns
constexpr int kBlock = 256;
constexpr int kItems = kTile * kTile * kGroups / kBlock;  // (pixel, group) items a thread owns
constexpr int kMaxP = 32;
constexpr int kLoads = 8;  // loads in flight per lane in the zero test
constexpr int kBatch = 8;  // RoIs whose weight tables are built together

struct Level {
  void* out;
  int h, w;
  float scale;
  int tiles_x, tiles;  // tiles per row, per image
};

struct Pyramid {
  Level lv[4];
};

// The weight that one sample at coordinate v (before the clamps) gives cell
// `pos` of an axis of n cells: hy at its low corner, ly at its high one,
// with the Detectron clamp and snap; zero outside [-1, n].
__device__ __forceinline__ float axis_weight(float v, int n, int pos) {
  if (v < -1.f || v > (float)n) return 0.f;
  float vc = fmaxf(v, 0.f);
  int lo = (int)floorf(vc), hi;
  if (lo >= n - 1) {
    lo = hi = n - 1;
    vc = (float)lo;
  } else {
    hi = lo + 1;
  }
  const float l = vc - (float)lo, h = 1.f - l;
  return (lo == pos ? h : 0.f) + (hi == pos ? l : 0.f);
}

// The scaled box of RoI `roi` at the level's scale, as roi_align_fpn.cu
// computes it: (x1, y1) and the bin sizes.
__device__ __forceinline__ void scaled_box(const float* rois, int roi, float scale, int P,
                                           float& x1, float& y1, float& bin_w,
                                           float& bin_h) {
  x1 = __fmul_rn(rois[roi * 4 + 0], scale);
  y1 = __fmul_rn(rois[roi * 4 + 1], scale);
  const float x2 = __fmul_rn(rois[roi * 4 + 2], scale);
  const float y2 = __fmul_rn(rois[roi * 4 + 3], scale);
  const float inv_p = __fdiv_rn(1.f, (float)P);
  bin_w = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 1.f), inv_p);
  bin_h = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 1.f), inv_p);
}

// Whether samples spread over [lo, lo + extent] can touch the cells
// [c0, c0 + kTile) of an axis: widened by one cell on each side, clamped
// below at 0 as the samples are. Conservative; a RoI kept in vain has zero
// weights on the tile.
__device__ __forceinline__ bool meets(float lo, float extent, int c0) {
  const float first = floorf(fmaxf(lo - 1.f, 0.f));
  const float last = floorf(fmaxf(lo + extent + 1.f, 0.f)) + 1.f;
  return last >= (float)c0 && first <= (float)(c0 + kTile - 1);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
fpn_roi_align_bwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, const T* __restrict__ grad,
                         int B, int R, int C, int P, int S, int slices) {
  extern __shared__ int kept[];  // R RoI indices, in RoI order
  __shared__ float by[kBatch][kTile][kMaxP], bx[kBatch][kTile][kMaxP];
  __shared__ int span[kBatch][2 * kTile][2];  // per RoI: rows, then columns
  __shared__ float box[kBatch][4];            // per RoI: x1, y1, bin_w, bin_h
  __shared__ int batch[kBatch];               // the batch's RoI indices
  __shared__ int n_batch, cursor;
  __shared__ int warp_kept[kBlock / 32];

  int idx = blockIdx.x;
  const int slice = idx % slices;
  idx /= slices;
  int l = 0;
  Level lv = pyr.lv[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // unrolled, so the levels stay out of local memory
    if (l == k && idx >= B * lv.tiles) {
      idx -= B * lv.tiles;
      l = k + 1;
      lv = pyr.lv[k + 1];
    }
  }
  const int H = lv.h, W = lv.w;
  const int b = idx / lv.tiles, tile = idx % lv.tiles;
  const int r0 = tile / lv.tiles_x * kTile, q0 = tile % lv.tiles_x * kTile;

  // the RoIs of this image and level whose footprint meets the tile, kept
  // in RoI order: a thread tests a run of consecutive RoIs (all loads in
  // flight together), and a block-wide prefix sum of the counts places them
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (R + kBlock - 1) / kBlock;  // at most 32
  const int first = threadIdx.x * per;
  unsigned flags = 0;
  for (int k = 0; k < per; ++k) {
    const int r = first + k;
    if (r >= R) break;
    const int roi = b * R + r;
    int lr = levels[roi];
    lr = lr < 0 ? 0 : (lr > 3 ? 3 : lr);
    if (lr == l) {
      float x1, y1, bin_w, bin_h;
      scaled_box(rois, roi, lv.scale, P, x1, y1, bin_w, bin_h);
      if (meets(y1, bin_h * P, r0) && meets(x1, bin_w * P, q0)) flags |= 1u << k;
    }
  }
  const int count = __popc(flags);
  int incl = count;
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_kept[warp] = incl;
  __syncthreads();
  int offset = incl - count, n_kept = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
    offset += w < warp ? warp_kept[w] : 0;
    n_kept += warp_kept[w];
  }
  for (int k = 0; flags; ++k, flags >>= 1) {
    if (flags & 1u) kept[offset++] = first + k;
  }
  if (threadIdx.x == 0) cursor = 0;
  __syncthreads();

  // a kept RoI whose gradient is zero in all of this block's channels (a
  // padded slot; they share one box and so pile up on one tile) is marked
  // -1: a warp scans its bins kLoads groups of 8 values a lane at a time,
  // all loads unconditional and in flight together (past the end a lane
  // reads the last group again), tests their bits (a value is non-zero iff
  // a bit besides the sign is set) and stops at the first non-zero one
  const int groups = C / 8;
  const int g0 = slice * kGroups, ng = min(kGroups, groups - g0);
  const int n_items = P * P * ng;
  constexpr int kWords = sizeof(T) / 2;  // 16-byte words per 8 values
  const unsigned magnitude = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  for (int i = warp; i < n_kept; i += kBlock / 32) {
    const T* g_roi = grad + (int64_t)(b * R + kept[i]) * P * P * C + g0 * 8;
    bool any = false;
    for (int u0 = 0; u0 < n_items && !any; u0 += 32 * kLoads) {
      uint4 v[kLoads][kWords];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int u = min(u0 + k * 32 + lane, n_items - 1);
        const uint4* q = reinterpret_cast<const uint4*>(g_roi + (int64_t)(u / ng) * C
                                                         + (u % ng) * 8);
#pragma unroll
        for (int w = 0; w < kWords; ++w) v[k][w] = __ldcg(q + w);
      }
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) bits |= (v[k][w].x | v[k][w].y | v[k][w].z | v[k][w].w);
      }
      // masking after the OR is exact: a magnitude bit of any value survives
      any = __any_sync(0xffffffffu, (bits & magnitude) != 0u);
    }
    if (lane == 0 && !any) kept[i] = -1;
  }
  __syncthreads();

  float acc[kItems][8];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[it][k] = 0.f;
  }
  for (;;) {
    // the next kBatch live RoIs, in RoI order
    if (threadIdx.x == 0) {
      int n = 0, c = cursor;
      while (n < kBatch && c < n_kept) {
        const int r = kept[c++];
        if (r >= 0) batch[n++] = r;
      }
      n_batch = n;
      cursor = c;
    }
    __syncthreads();
    const int nb = n_batch;
    if (nb == 0) break;
    if (threadIdx.x < nb) {
      float* bx4 = box[threadIdx.x];
      scaled_box(rois, b * R + batch[threadIdx.x], lv.scale, P, bx4[0], bx4[1], bx4[2],
                 bx4[3]);
    }
    __syncthreads();
    // the bins' weights on the tile's rows (By) and columns (Bx), RoI by RoI
    for (int u = threadIdx.x; u < nb * 2 * kTile * P; u += kBlock) {
      const int m = u / (2 * kTile * P), v = u % (2 * kTile * P);
      const bool row = v < kTile * P;
      const int cv = row ? v : v - kTile * P;
      const int cell = cv / P, bin = cv % P;
      const int pos = (row ? r0 : q0) + cell, n_cells = row ? H : W;
      const float start = box[m][row ? 1 : 0], size = box[m][row ? 3 : 2];
      float wsum = 0.f;
      if (pos < n_cells) {
        for (int i = 0; i < S; ++i) {
          const float f = __fadd_rn((float)bin, __fdiv_rn((float)i + 0.5f, (float)S));
          wsum += axis_weight(__fmaf_rn(f, size, start), n_cells, pos);
        }
      }
      (row ? by : bx)[m][cell][bin] = wsum;
    }
    __syncthreads();
    // per RoI and tile row (column), the first and last bin with a weight
    for (int u = threadIdx.x; u < nb * 2 * kTile; u += kBlock) {
      const int m = u / (2 * kTile), v = u % (2 * kTile);
      const float* wts = v < kTile ? by[m][v] : bx[m][v - kTile];
      int lo = P, hi = -1;
      for (int bin = 0; bin < P; ++bin) {
        if (wts[bin] != 0.f) {
          lo = min(lo, bin);
          hi = bin;
        }
      }
      span[m][v][0] = lo;
      span[m][v][1] = hi;
    }
    __syncthreads();
    for (int m = 0; m < nb; ++m) {
      const T* g_roi = grad + (int64_t)(b * R + batch[m]) * P * P * C;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int item = threadIdx.x + it * kBlock;
        const int p = item / kGroups, grp = g0 + item % kGroups;
        const int rr = p / kTile, qq = p % kTile;
        if (grp >= groups) continue;
        const int pw_lo = span[m][kTile + qq][0], pw_hi = span[m][kTile + qq][1];
        for (int ph = span[m][rr][0]; ph <= span[m][rr][1]; ++ph) {
          const float wr = by[m][rr][ph];
          for (int pw = pw_lo; pw <= pw_hi; ++pw) {
            const float w = wr * bx[m][qq][pw];
            float gv[8];
            load8(g_roi + (int64_t)(ph * P + pw) * C + grp * 8, gv);
            bool any = false;
#pragma unroll
            for (int k = 0; k < 8; ++k) any |= gv[k] != 0.f;
            if (!any) continue;  // a zero bin: no arithmetic
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[it][k] = fmaf(w, gv[k], acc[it][k]);
          }
        }
      }
    }
    __syncthreads();  // the tables are rewritten for the next batch
  }

  const float inv_ss = 1.f / (float)(S * S);
  T* out = static_cast<T*>(lv.out);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = threadIdx.x + it * kBlock;
    const int p = item / kGroups, grp = slice * kGroups + item % kGroups;
    const int i = r0 + p / kTile, j = q0 + p % kTile;
    if (grp >= groups || i >= H || j >= W) continue;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = acc[it][k] * inv_ss;
    store8(out + (((int64_t)b * H + i) * W + j) * C + grp * 8, v);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of grad and of the four outputs).
// o0..o3 are the level gradients (B, H_l, W_l, C), every element written;
// rois (B, R, 4) f32, levels (B, R) int32, grad (B, R, P, P, C). P <= 32,
// R <= 8192 (a thread tests at most 32 RoIs).
int fpn_roi_align_bwd(void* o0, void* o1, void* o2, void* o3, const void* rois,
                      const void* levels, const void* grad, int B, int R, int C, int P,
                      int S, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
                      int w3, float sc0, float sc1, float sc2, float sc3, int dtype,
                      void* stream) {
  Pyramid pyr;
  void* outs[4] = {o0, o1, o2, o3};
  const int hs[4] = {h0, h1, h2, h3}, ws[4] = {w0, w1, w2, w3};
  const float scs[4] = {sc0, sc1, sc2, sc3};
  int64_t tiles = 0;
  for (int l = 0; l < 4; ++l) {
    const int tx = (ws[l] + kTile - 1) / kTile, ty = (hs[l] + kTile - 1) / kTile;
    pyr.lv[l] = Level{outs[l], hs[l], ws[l], scs[l], tx, tx * ty};
    tiles += (int64_t)B * tx * ty;
  }
  const int slices = (C / 8 + kGroups - 1) / kGroups;
  const int64_t grid = tiles * slices;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0 && C >= 8 && P <= kMaxP) {
    const size_t bytes = (size_t)R * sizeof(int);
    if (dtype == 1) {
      fpn_roi_align_bwd_kernel<__nv_bfloat16><<<(unsigned)grid, kBlock, bytes, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<const __nv_bfloat16*>(grad), B, R, C, P, S, slices);
    } else {
      fpn_roi_align_bwd_kernel<float><<<(unsigned)grid, kBlock, bytes, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<const float*>(grad), B, R, C, P, S, slices);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
