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
// then x 1/S^2 (exact, S^2 being a power of two) and one rounding. The RoI
// reads its own level directly, so no window, strip loop or level padding is
// needed.
//
// S 1, 2 and 4 (the ratios the TPU kernel takes) are those unrolled
// instances. Any other S >= 1, which the reference computes off the TPU, runs
// the same thread with S as a runtime loop bound: one sample's four corners in
// flight at a time, in the same order, each term a rounded product and a
// rounded add, and the average divided (__fdiv_rn) as the plain version
// divides. At S = 3 a multiply by 1/9 would round otherwise. So that path
// gives the plain version's bits, and the unrolled ones lie within one
// rounding of them.
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

// What a thread needs before its samples: its level's map at its image and
// channel group, the map's size, and its bin's origin and size.
template <typename T>
struct BinSetup {
  const T* feat;
  int H, W, row_elems, ph, pw;
  float x1, y1, bin_w, bin_h;
};

// n_threads = B * R * P * P * C / 8 < 2^31, so every quotient is quot's.
template <typename T>
__device__ __forceinline__ BinSetup<T> bin_setup(const Pyramid& pyr, const float* rois,
                                                 const int* levels, uint32_t tid,
                                                 const FastDiv& groups, const FastDiv& bins,
                                                 const FastDiv& rois_per_image,
                                                 const FastDiv& pooled, int C, float inv_p) {
  BinSetup<T> s;
  const uint32_t roi_bin = quot(tid, groups);  // roi * P * P + bin
  const uint32_t roi = quot(roi_bin, bins);    // b * R + r
  const int bin = (int)(roi_bin - roi * bins.d);
  s.ph = (int)quot((uint32_t)bin, pooled);
  s.pw = bin - s.ph * (int)pooled.d;
  const int b = (int)quot(roi, rois_per_image);
  // the RoI's record is loaded before its level is known
  const float* rec = rois + (int64_t)roi * 4;
  const float rx1 = __ldg(rec + 0), ry1 = __ldg(rec + 1), rx2 = __ldg(rec + 2),
              ry2 = __ldg(rec + 3);
  int l = __ldg(levels + roi);
  l = l < 0 ? 0 : (l > 3 ? 3 : l);
  const Level& lv = pyr.lv[l];  // read in place (__grid_constant__), no local copy
  s.H = lv.h;
  s.W = lv.w;
  s.row_elems = s.W * C;
  s.feat = static_cast<const T*>(lv.feat) + (int64_t)b * s.H * s.W * C +
           (int)(tid - roi_bin * groups.d) * 8;
  s.x1 = __fmul_rn(rx1, lv.scale);
  s.y1 = __fmul_rn(ry1, lv.scale);
  const float x2 = __fmul_rn(rx2, lv.scale);
  const float y2 = __fmul_rn(ry2, lv.scale);
  s.bin_w = __fmul_rn(fmaxf(__fsub_rn(x2, s.x1), 1.f), inv_p);
  s.bin_h = __fmul_rn(fmaxf(__fsub_rn(y2, s.y1), 1.f), inv_p);
  return s;
}

// Sample i of S along one axis of the bin at p: origin + (p + (i + 0.5) / S) * size.
__device__ __forceinline__ float sample_at(int p, int i, int S, float size, float origin) {
  return __fmaf_rn(__fadd_rn((float)p, __fdiv_rn((float)i + 0.5f, (float)S)), size, origin);
}

// The corners' sum of one sample, weights ll, lh, hl, hh, into acc: one
// fmaf a term where kFused, else a rounded product and a rounded add, as the
// plain version computes it.
template <bool kFused, typename T>
__device__ __forceinline__ void add_sample(const Raw8<T> (&raw)[4], const Axis& ya,
                                           const Axis& xa, float* acc) {
  const float wgt[4] = {ya.h * xa.h, ya.h * xa.l, ya.l * xa.h, ya.l * xa.l};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[8];
    widen8(raw[q], v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] = kFused ? fmaf(wgt[q], v[k], acc[k]) : __fadd_rn(acc[k], __fmul_rn(wgt[q], v[k]));
    }
  }
}

// The average over the S * S samples, rounded once to T: divided as the
// plain version divides, or, where S is a power of two, multiplied by the
// exact reciprocal of S * S (the same bits without the division's registers;
// a constant S folds the test away).
template <typename T>
__device__ __forceinline__ void store_mean(T* out, float* acc, int S) {
  const float ss = (float)(S * S);
  const bool pow2 = (S & (S - 1)) == 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = pow2 ? acc[k] * (1.f / ss) : __fdiv_rn(acc[k], ss);
  store8(out, acc);
}

// S of 1, 2 or 4, unrolled: a chunk of samples' corners in flight at once.
template <typename T, int S>
__global__ void __launch_bounds__(kBlock)
fpn_roi_align_kernel(const __grid_constant__ Pyramid pyr, const float* __restrict__ rois,
                     const int* __restrict__ levels, T* __restrict__ out, uint32_t n_threads,
                     FastDiv groups, FastDiv bins, FastDiv rois_per_image, FastDiv pooled,
                     int C, float inv_p) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const BinSetup<T> bs =
      bin_setup<T>(pyr, rois, levels, tid, groups, bins, rois_per_image, pooled, C, inv_p);
  Axis ay[S], ax[S];
  const T* row[2 * S];  // the rows lo, hi of each sample row
  int col[2 * S];       // the element offsets of the columns lo, hi of each sample column
#pragma unroll
  for (int i = 0; i < S; ++i) {
    ay[i] = axis_at(sample_at(bs.ph, i, S, bs.bin_h, bs.y1), bs.H);
    ax[i] = axis_at(sample_at(bs.pw, i, S, bs.bin_w, bs.x1), bs.W);
    row[2 * i] = bs.feat + (int64_t)ay[i].lo * bs.row_elems;
    row[2 * i + 1] = bs.feat + (int64_t)ay[i].hi * bs.row_elems;
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
      if (ok[j]) add_sample<true, T>(raw[j], ay[(s0 + j) / S], ax[(s0 + j) % S], acc);
    }
  }
  store_mean(out + (int64_t)tid * 8, acc, S);
}

// Any other S >= 1, a runtime bound: the same thread, samples and order, one
// sample's four corners in flight at a time, each column's axis recomputed per
// sample row (registers do not hold S of them), and each term unfused, so
// the sums are the plain version's bit for bit.
template <typename T>
__global__ void __launch_bounds__(kBlock)
fpn_roi_align_any_kernel(const __grid_constant__ Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, T* __restrict__ out,
                         uint32_t n_threads, FastDiv groups, FastDiv bins,
                         FastDiv rois_per_image, FastDiv pooled, int C, float inv_p, int S) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const BinSetup<T> bs =
      bin_setup<T>(pyr, rois, levels, tid, groups, bins, rois_per_image, pooled, C, inv_p);
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int iy = 0; iy < S; ++iy) {
    const Axis ya = axis_at(sample_at(bs.ph, iy, S, bs.bin_h, bs.y1), bs.H);
    if (!ya.in) continue;
    const T* rows[2] = {bs.feat + (int64_t)ya.lo * bs.row_elems,
                        bs.feat + (int64_t)ya.hi * bs.row_elems};
    for (int ix = 0; ix < S; ++ix) {
      const Axis xa = axis_at(sample_at(bs.pw, ix, S, bs.bin_w, bs.x1), bs.W);
      if (!xa.in) continue;
      const int cols[2] = {xa.lo * C, xa.hi * C};
      Raw8<T> raw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) raw[q] = ldg8(rows[q >> 1] + cols[q & 1]);
      add_sample<false, T>(raw, ya, xa, acc);
    }
  }
  store_mean(out + (int64_t)tid * 8, acc, S);
}

// S 1, 2 and 4 take their unrolled instances, any other S the runtime one.
template <typename T>
int launch(const Pyramid& pyr, const void* rois, const void* levels, void* out,
           int64_t threads, int R, int C, int P, int S, cudaStream_t s) {
  const unsigned grid = (unsigned)((threads + kBlock - 1) / kBlock);
  // the host's float32 division rounds as the device's __fdiv_rn
  const float inv_p = 1.f / (float)P;
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  T* o = static_cast<T*>(out);
  const uint32_t n = (uint32_t)threads;
  const FastDiv groups = fast_div(C / 8), bins = fast_div(P * P), per_image = fast_div(R),
                pooled = fast_div(P);
  switch (S) {
    case 1:
      fpn_roi_align_kernel<T, 1><<<grid, kBlock, 0, s>>>(pyr, r, l, o, n, groups, bins,
                                                         per_image, pooled, C, inv_p);
      break;
    case 2:
      fpn_roi_align_kernel<T, 2><<<grid, kBlock, 0, s>>>(pyr, r, l, o, n, groups, bins,
                                                         per_image, pooled, C, inv_p);
      break;
    case 4:
      fpn_roi_align_kernel<T, 4><<<grid, kBlock, 0, s>>>(pyr, r, l, o, n, groups, bins,
                                                         per_image, pooled, C, inv_p);
      break;
    default:
      if (S < 1) return (int)cudaErrorInvalidValue;
      fpn_roi_align_any_kernel<T><<<grid, kBlock, 0, s>>>(pyr, r, l, o, n, groups, bins,
                                                          per_image, pooled, C, inv_p, S);
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. f0..f3 are the (B, H_l, W_l, C) levels,
// rois (B, R, 4) f32, levels (B, R) int32, out (B, R, P, P, C); any S >= 1;
// B * R * P * P * C / 8 < 2^31.
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
        ? launch<__nv_bfloat16>(pyr, rois, levels, out, threads, R, C, P, S, s)
        : launch<float>(pyr, rois, levels, out, threads, R, C, P, S, s);
    if (status) return status;
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
