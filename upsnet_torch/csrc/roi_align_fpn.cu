// K4: FPN ROIAlign forward over the P2..P5 pyramid, Detectron clamp.
//
// out[b, r, ph, pw, :] = mean over the S x S samples of bin (ph, pw) of RoI
// (b, r) of the bilinear value of its level's map, with the Detectron
// semantics of upsnet_tpu/ops/roi_align.py: no half-pixel shift,
// roi_w = max(x2 - x1, 1) after scaling, samples outside [-1, H] x [-1, W]
// count zero, coordinates clamp below at 0 and snap to the last row/column,
// and the level index clamps to [0, 3].
// Replaces the TPU kernel upsnet_tpu/ops/roi_align_pallas.py:
// fpn_roi_align_window (_window_kernel).
//
// One thread per (RoI, bin, group of 8 channels) over a flat index,
// group fastest, then bin, then RoI, in 128-thread blocks: at C = 256 a warp
// is one bin, its 32 lanes read 512 contiguous bytes per corner, and the
// RoI's record and level are one broadcast load. Every SM is filled, even by
// the 200 RoIs of a mask call, and no thread walks a tail of items. A thread
// computes its bin's S row and S column coordinates once (low and high cell,
// weights, whether the sample counts along that axis), then issues the
// corner loads of a chunk of samples, predicated on the sample counting,
// before the chunk's first FMA: all S * S * 4 = 16 corners of a bin at S = 2
// in bf16 (one 16-byte load each, 4 registers of raw words), one sample row
// (8 corners, two 16-byte loads each) in f32. The sums keep one order:
// samples by row, then column; corners ll, lh, hl, hh; one fmaf a channel;
// then x 1/S^2 and one rounding. The RoI reads its own level directly, so no
// window, strip loop or level padding is needed.
//
// Bound by bytes: the feature rows the samples touch and the output. With 8
// channels a thread the work per byte is high (a thread's index and
// coordinate arithmetic serves 8 channels), and a thread waits on two
// dependent loads (the RoI's record and level, then its corners), so the
// kernel is held by latency at 24 warps an SM (79 registers in bf16). What
// the design does about it: the flat index is 32-bit and divides by multiply
// and shift (FastDiv), the level is read from the __grid_constant__
// parameter in place, the record is loaded before the level is known, and
// 128-thread blocks schedule more evenly than 256 at the same occupancy. A
// call of 2^31 threads or more (an output of 16 Gi elements) is refused.
//
// Sample coordinates round as XLA compiles the JAX expression (the bin size
// as the extent times the float32 reciprocal of P, then one fused
// multiply-add), so they equal the plain PyTorch version's bit for bit.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

constexpr int kBlock = 128;

struct Level {
  const void* feat;
  int h, w;
  float scale;
};

struct Pyramid {
  Level lv[4];
};

// Division by d as one 32 x 32 -> 64-bit multiply and a shift for a
// dividend below 2^31 (Granlund and Montgomery): m = floor(2^(31 + l) / d) + 1
// with l = ceil(log2 d).
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  return {d, (uint32_t)((1ull << (31 + l)) / d + 1), 31 + l};
}

__device__ __forceinline__ uint32_t quot(uint32_t n, const FastDiv& f) {
  return (uint32_t)(((uint64_t)n * f.m) >> f.s);
}

// One axis of a sample at v on an axis of n cells: its low and high cells
// (clamped below at 0, snapped to n - 1), their weights h and l, and whether
// the sample lies in [-1, n].
struct Axis {
  int lo, hi;
  float l, h;
  bool in;
};

__device__ __forceinline__ Axis axis_at(float v, int n) {
  Axis a;
  a.in = !(v < -1.f || v > (float)n);
  float c = fmaxf(v, 0.f);
  a.lo = (int)floorf(c);
  if (a.lo >= n - 1) {
    a.lo = a.hi = n - 1;
    c = (float)a.lo;
  } else {
    a.hi = a.lo + 1;
  }
  a.l = c - (float)a.lo;
  a.h = 1.f - a.l;
  return a;
}

// n_threads = B * R * P * P * C / 8 < 2^31, so every quotient is quot's.
template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
fpn_roi_align_kernel(const __grid_constant__ Pyramid pyr, const float* __restrict__ rois,
                     const int* __restrict__ levels, T* __restrict__ out, uint32_t n_threads,
                     FastDiv groups, FastDiv bins, FastDiv rois_per_image, FastDiv pooled,
                     int C, float inv_p) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const uint32_t roi_bin = quot(tid, groups);  // roi * P * P + bin
  const uint32_t roi = quot(roi_bin, bins);    // b * R + r
  const int bin = (int)(roi_bin - roi * bins.d);
  const int ph = (int)quot((uint32_t)bin, pooled), pw = bin - ph * (int)pooled.d;
  const int b = (int)quot(roi, rois_per_image);
  // the RoI's record is loaded before its level is known
  const float* rec = rois + (int64_t)roi * 4;
  const float rx1 = __ldg(rec + 0), ry1 = __ldg(rec + 1), rx2 = __ldg(rec + 2),
              ry2 = __ldg(rec + 3);
  int l = __ldg(levels + roi);
  l = l < 0 ? 0 : (l > 3 ? 3 : l);
  const Level& lv = pyr.lv[l];  // read in place (__grid_constant__), no local copy
  const int H = lv.h, W = lv.w;
  const T* feat = static_cast<const T*>(lv.feat) + (int64_t)b * H * W * C +
                  (int)(tid - roi_bin * groups.d) * 8;

  const float x1 = __fmul_rn(rx1, lv.scale);
  const float y1 = __fmul_rn(ry1, lv.scale);
  const float x2 = __fmul_rn(rx2, lv.scale);
  const float y2 = __fmul_rn(ry2, lv.scale);
  const float bin_w = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 1.f), inv_p);
  const float bin_h = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 1.f), inv_p);
  const int row_elems = W * C;
  Axis ay[S], ax[S];
  const T* row[2 * S];  // the rows lo, hi of each sample row
  int col[2 * S];       // the element offsets of the columns lo, hi of each sample column
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float f = __fdiv_rn((float)i + 0.5f, (float)S);
    ay[i] = axis_at(__fmaf_rn(__fadd_rn((float)ph, f), bin_h, y1), H);
    ax[i] = axis_at(__fmaf_rn(__fadd_rn((float)pw, f), bin_w, x1), W);
    row[2 * i] = feat + (int64_t)ay[i].lo * row_elems;
    row[2 * i + 1] = feat + (int64_t)ay[i].hi * row_elems;
    col[2 * i] = ax[i].lo * C;
    col[2 * i + 1] = ax[i].hi * C;
  }

  // samples whose corners are loaded together: 64 registers of raw words
  constexpr int kSamples = S * S;
  constexpr int kChunk = sizeof(T) == 2 ? 4 : 2;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int s0 = 0; s0 < kSamples; s0 += kChunk) {
    Raw8<T> raw[kChunk][4];
    bool ok[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int iy = (s0 + j) / S, ix = (s0 + j) % S;
      ok[j] = s0 + j < kSamples && ay[iy].in && ax[ix].in;
      if (!ok[j]) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        raw[j][q] = ldg8(row[2 * iy + (q >> 1)] + col[2 * ix + (q & 1)]);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (!ok[j]) continue;
      const Axis& ya = ay[(s0 + j) / S];
      const Axis& xa = ax[(s0 + j) % S];
      const float wgt[4] = {ya.h * xa.h, ya.h * xa.l, ya.l * xa.h, ya.l * xa.l};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[8];
        widen8(raw[j][q], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt[q], v[k], acc[k]);
      }
    }
  }
  const float inv_ss = 1.f / (float)(S * S);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] *= inv_ss;
  store8(out + (int64_t)tid * 8, acc);
}

template <typename T, int S>
void launch(const Pyramid& pyr, const void* rois, const void* levels, void* out,
            int64_t threads, int R, int C, int P, cudaStream_t s) {
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  // the host's float32 division rounds as the device's __fdiv_rn
  const float inv_p = 1.f / (float)P;
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  const FastDiv groups = fast_div(C / 8), bins = fast_div(P * P), per_image = fast_div(R),
                pooled = fast_div(P);
  fpn_roi_align_kernel<T, S><<<grid, kBlock, 0, s>>>(
      pyr, r, l, static_cast<T*>(out), (uint32_t)threads, groups, bins, per_image, pooled, C,
      inv_p);
}

template <typename T>
int launch_any(const Pyramid& pyr, const void* rois, const void* levels, void* out,
               int64_t threads, int R, int C, int P, int S, cudaStream_t s) {
  switch (S) {
    case 1: launch<T, 1>(pyr, rois, levels, out, threads, R, C, P, s); break;
    case 2: launch<T, 2>(pyr, rois, levels, out, threads, R, C, P, s); break;
    case 4: launch<T, 4>(pyr, rois, levels, out, threads, R, C, P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. f0..f3 are the (B, H_l, W_l, C) levels,
// rois (B, R, 4) f32, levels (B, R) int32, out (B, R, P, P, C); S 1, 2 or 4,
// the sampling ratios the TPU kernel takes; B * R * P * P * C / 8 < 2^31.
int fpn_roi_align(const void* f0, const void* f1, const void* f2, const void* f3,
                  const void* rois, const void* levels, void* out,
                  int B, int R, int C, int P, int S,
                  int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                  float sc0, float sc1, float sc2, float sc3,
                  int dtype, void* stream) {
  Pyramid pyr;
  pyr.lv[0] = Level{f0, h0, w0, sc0};
  pyr.lv[1] = Level{f1, h1, w1, sc1};
  pyr.lv[2] = Level{f2, h2, w2, sc2};
  pyr.lv[3] = Level{f3, h3, w3, sc3};
  const int64_t threads = (int64_t)B * R * P * P * (C / 8);
  if (threads >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads > 0) {
    const int status = dtype == 1
        ? launch_any<__nv_bfloat16>(pyr, rois, levels, out, threads, R, C, P, S, s)
        : launch_any<float>(pyr, rois, levels, out, threads, R, C, P, S, s);
    if (status) return status;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
