// The semantic half of the test-time-augmentation (TTA) merge, the fusion's
// resample of its result, and each variant's input canvas, on the card.
//
// tta_merge: for every frame pixel (y, x) and channel c
//   avg[y, x, c] = (sum over the variants v, in order, of
//                   resize(flip_v(map_v[:rows_v, :cols_v]))[y, x, c]) / n
//   argmax[y, x] = the first c of the largest avg[y, x, c] (np.argmax's rule:
//                  the first NaN, if any)
// tta_resample: avg resized to the first variant's quarter-scale content
// (ch, cw), laid at the top-left of a (qh, qw) canvas that is zero elsewhere.
// tta_sample: one variant's (bh, bw, 3) input canvas from the (h, w, 3) uint8
// BGR frame:
//   canvas[y, x, c] = resize(float(frame))[y, flip ? rw - 1 - x : x, c] - mean[c]
//   for y < min(rh, bh), x < min(rw, bw), zero elsewhere, rounded to the
//   canvas's dtype (bf16 by __float2bfloat16_rn, as the host's cast rounds);
//   where the content (rh, rw) outgrows the bucket, the canvas holds its
//   top-left, as the host's pad_to_bucket(flip_image(img)) crops.
//
// None of them replaces a TPU kernel: the JAX package merges on the host with
// cv2 and builds its samples there (upsnet_tpu/evaluation/tta.py,
// upsnet_tpu/data/base.py), and so did the port until these kernels.
// `resize` is cv2.resize's INTER_LINEAR on float32 as cv2 computes it, so that
// the plain version (upsnet_torch/ops/tta_merge.py) and the host merge it
// replaces agree exactly:
// - source position (float)((d + 0.5) * s - 0.5), in double with
//   s = 1 / (dst / src), then floor and fraction in float;
// - columns clamp the position, weights included (before the first column
//   and from the last on, the weights are 1 and 0); rows clamp the row
//   index and keep the weights;
// - the horizontal pass first, each value a rounded product plus a rounded
//   product, then the vertical pass the same way, float32 throughout, no
//   fused multiply-add (the __f*_rn intrinsics stop nvcc contracting);
// - where the source is exactly twice the destination on both axes, cv2
//   takes INTER_AREA instead: (((a + b) + c) + d) * 0.25f over the 2x2 block.
//   Both entry points reproduce that switch (the wrapper decides it).
// The sum runs over the variants in order and divides by n as the host's
// `seg_sum + seg` and `/ n_seg` did.
//
// One thread per output pixel, 128 pixels a block: a thread computes each
// variant's four tap offsets and weights once and walks the channels, so the
// coordinate arithmetic (a few double operations a variant and axis) is paid
// once per pixel and not per channel. The channels of a pixel are contiguous
// (H, W, C), so a thread's reads of a tap are C contiguous floats, cached in
// L1 across the neighbours that share the tap (4 output pixels a source pixel
// at the cell's 4x upscale). The outputs go through shared memory: the block
// writes its 128 x C contiguous floats with consecutive threads on
// consecutive addresses, instead of 32 scattered 4-byte stores a warp and
// channel.
//
// tta_sample takes the same rule on the frame's bytes (a tap's value is
// float(u8), exact), with one thread a canvas pixel and its three channels:
// the taps once a pixel, not once a channel. A block's 256 pixels are 768
// contiguous canvas values, staged in shared memory and written with 16-byte
// stores, consecutive threads on consecutive addresses.
//
// Bound by bytes. At the Cityscapes TTA cell (six 19-channel maps, crops
// 256x512 four times and 192x384 twice, into 1024x2048): 51.0 MB of crops
// read, 159.4 MB of averages and 2.1 MB of argmax written, 212.5 MB, 0.063 ms
// at 3.35 TB/s. The resample to 256x512 reads the rows and columns its taps
// touch (half of each at 4x, 39.8 MB) and writes 10.0 MB: 0.015 ms. A sample
// of the 1024x2048 frame reads the frame rows and columns its taps touch (all
// of it at unit scale, 6.3 MB) and writes the 1024x2048x3 canvas (12.6 MB in
// bf16): 18.9 MB, 0.0056 ms.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxMaps = 8;
constexpr int kDefaultSmem = 48 * 1024;

struct Map {
  const float* src;
  int rows, cols;  // the crop that is resized (clamped to the map by the wrapper)
  int pitch;       // the map's width in pixels
  int flip;        // read the crop's columns mirrored
  int area;        // cv2's exact-2x INTER_AREA switch
  double sy, sx;   // cv2's 1 / (dst / src) per axis
};

struct Maps {
  Map m[kMaxMaps];
  int n;
};

// Element offsets of a destination pixel's four taps, and their weights.
struct Taps {
  int o00, o01, o10, o11;
  float a0, a1, b0, b1;
};

__device__ __forceinline__ float source_pos(int d, double scale) {
  return __double2float_rn(__dadd_rn(__dmul_rn(__dadd_rn((double)d, 0.5), scale), -0.5));
}

// cv2's column rule: the position is clamped, weights included.
__device__ __forceinline__ void col_taps(int d, double scale, int n, int& i0, int& i1,
                                         float& w0, float& w1) {
  float f = source_pos(d, scale);
  int s = (int)floorf(f);
  f = __fsub_rn(f, (float)s);
  if (s < 0) {
    s = 0;
    f = 0.f;
  }
  if (s >= n - 1) {
    s = n - 1;
    f = 0.f;
  }
  i0 = s;
  i1 = min(s + 1, n - 1);
  w0 = __fsub_rn(1.f, f);
  w1 = f;
}

// cv2's row rule: the row index is clamped, the weights are kept.
__device__ __forceinline__ void row_taps(int d, double scale, int n, int& i0, int& i1,
                                         float& w0, float& w1) {
  float f = source_pos(d, scale);
  const int s = (int)floorf(f);
  f = __fsub_rn(f, (float)s);
  i0 = min(max(s, 0), n - 1);
  i1 = min(max(s + 1, 0), n - 1);
  w0 = __fsub_rn(1.f, f);
  w1 = f;
}

__device__ __forceinline__ Taps taps_of(const Map& m, int y, int x, int C) {
  int r0, r1, q0, q1;
  Taps t;
  t.a0 = t.a1 = t.b0 = t.b1 = 0.f;
  if (m.area) {
    r0 = 2 * y;
    r1 = r0 + 1;
    q0 = 2 * x;
    q1 = q0 + 1;
  } else {
    row_taps(y, m.sy, m.rows, r0, r1, t.b0, t.b1);
    col_taps(x, m.sx, m.cols, q0, q1, t.a0, t.a1);
  }
  if (m.flip) {
    q0 = m.cols - 1 - q0;
    q1 = m.cols - 1 - q1;
  }
  t.o00 = (r0 * m.pitch + q0) * C;
  t.o01 = (r0 * m.pitch + q1) * C;
  t.o10 = (r1 * m.pitch + q0) * C;
  t.o11 = (r1 * m.pitch + q1) * C;
  return t;
}

// The resized value of channel c from the four taps of src (float32 maps or
// the uint8 frame; a tap's value is its float).
template <typename Src>
__device__ __forceinline__ float lerp(const Src* src, const Taps& t, int area, int c) {
  const float v00 = __ldg(src + t.o00 + c), v01 = __ldg(src + t.o01 + c);
  const float v10 = __ldg(src + t.o10 + c), v11 = __ldg(src + t.o11 + c);
  if (area) return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(v00, v01), v10), v11), 0.25f);
  const float h0 = __fadd_rn(__fmul_rn(v00, t.a0), __fmul_rn(v01, t.a1));
  const float h1 = __fadd_rn(__fmul_rn(v10, t.a0), __fmul_rn(v11, t.a1));
  return __fadd_rn(__fmul_rn(h0, t.b0), __fmul_rn(h1, t.b1));
}

__device__ __forceinline__ float sample(const Map& m, const Taps& t, int c) {
  return lerp(m.src, t, m.area, c);
}

// The block's pixels [first, first + kBlock) are contiguous in the output:
// write their staged channels with consecutive threads on consecutive floats.
__device__ __forceinline__ void store_staged(const float* stage, float* __restrict__ out,
                                             int first, int npix, int C) {
  __syncthreads();
  const int n = min(kBlock, npix - first) * C;
  float* dst = out + (int64_t)first * C;
  for (int i = threadIdx.x; i < n; i += kBlock) dst[i] = stage[i];
}

__global__ void __launch_bounds__(kBlock)
tta_merge_kernel(const Maps maps, float* __restrict__ avg, uint8_t* __restrict__ argmax,
                 int oh, int ow, int C) {
  extern __shared__ float stage[];
  const int npix = oh * ow;
  const int first = blockIdx.x * kBlock;
  const int p = first + threadIdx.x;
  if (p < npix) {
    const int y = p / ow, x = p - y * ow;
    Taps t[kMaxMaps];
#pragma unroll
    for (int v = 0; v < kMaxMaps; ++v)
      if (v < maps.n) t[v] = taps_of(maps.m[v], y, x, C);
    const float count = (float)maps.n;
    float best = 0.f;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      float acc = sample(maps.m[0], t[0], c);
#pragma unroll
      for (int v = 1; v < kMaxMaps; ++v)
        if (v < maps.n) acc = __fadd_rn(acc, sample(maps.m[v], t[v], c));
      const float a = __fdiv_rn(acc, count);
      stage[threadIdx.x * C + c] = a;
      if (c == 0 || a > best || (a != a && best == best)) {
        best = a;
        arg = c;
      }
    }
    argmax[p] = (uint8_t)arg;
  }
  store_staged(stage, avg, first, npix, C);
}

__global__ void __launch_bounds__(kBlock)
tta_resample_kernel(const Map m, float* __restrict__ out, int qh, int qw, int ch, int cw,
                    int C) {
  extern __shared__ float stage[];
  const int npix = qh * qw;
  const int first = blockIdx.x * kBlock;
  const int p = first + threadIdx.x;
  if (p < npix) {
    const int y = p / qw, x = p - y * qw;
    float* s = stage + threadIdx.x * C;
    if (y < ch && x < cw) {
      const Taps t = taps_of(m, y, x, C);
      for (int c = 0; c < C; ++c) s[c] = sample(m, t, c);
    } else {
      for (int c = 0; c < C; ++c) s[c] = 0.f;
    }
  }
  store_staged(stage, out, first, npix, C);
}

constexpr int kSampleBlock = 256;

struct Means {
  float v[3];
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// m: the frame's geometry (rows h, cols w, pitch w, area, sy, sx; src and
// flip unused); (ch, cw) = min((rh, rw), (bh, bw)).
template <typename Out>
__global__ void __launch_bounds__(kSampleBlock)
tta_sample_kernel(const uint8_t* __restrict__ frame, Out* __restrict__ canvas, const Map m,
                  int ch, int cw, int rw, int bw, int npix, int flip, const Means mean) {
  __shared__ __align__(16) unsigned char smem[kSampleBlock * 3 * sizeof(Out)];
  Out* stage = reinterpret_cast<Out*>(smem);
  const int first = blockIdx.x * kSampleBlock;
  const int p = first + threadIdx.x;
  if (p < npix) {
    const int y = p / bw, x = p - y * bw;
    Out* s = stage + threadIdx.x * 3;
    if (y < ch && x < cw) {
      const Taps t = taps_of(m, y, flip ? rw - 1 - x : x, 3);
#pragma unroll
      for (int c = 0; c < 3; ++c) put(s + c, __fsub_rn(lerp(frame, t, m.area, c), mean.v[c]));
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) put(s + c, 0.f);
    }
  }
  __syncthreads();
  // the block's values are contiguous from a 16-byte boundary (first * 3 is a
  // multiple of 768): 16-byte stores, then the odd tail of the last block
  constexpr int kVec = 16 / sizeof(Out);
  const int n = min(kSampleBlock, npix - first) * 3;
  Out* dst = canvas + (int64_t)first * 3;
  const uint4* src4 = reinterpret_cast<const uint4*>(smem);
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n / kVec; i += kSampleBlock) dst4[i] = src4[i];
  for (int i = n / kVec * kVec + threadIdx.x; i < n; i += kSampleBlock) dst[i] = stage[i];
}

template <typename Out>
int launch_sample(const void* frame, void* canvas, const Map& m, int ch, int cw, int rw, int bw,
                  int npix, int flip, const Means& mean, cudaStream_t stream) {
  tta_sample_kernel<Out><<<(npix + kSampleBlock - 1) / kSampleBlock, kSampleBlock, 0, stream>>>(
      static_cast<const uint8_t*>(frame), static_cast<Out*>(canvas), m, ch, cw, rw, bw, npix,
      flip, mean);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int staged_smem(Kernel kernel, int C, size_t* bytes) {
  *bytes = (size_t)kBlock * C * sizeof(float);
  if (*bytes <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

}  // namespace

extern "C" {

// maps: n (<= 8) device pointers to (H, W, C) float32 maps; dims: per map
// rows, cols (the crop), pitch (W), flip, area; scales: per map sy, sx;
// avg (oh, ow, C) float32, argmax (oh, ow) uint8; C <= 256; oh * ow < 2^31,
// each map's H * W * C < 2^31. dtype must be 0 (float32).
int tta_merge(const void* const* maps, const int* dims, const double* scales, int n,
              void* avg, void* argmax, int oh, int ow, int C, int dtype, void* stream) {
  if (n < 1 || n > kMaxMaps || C < 1 || C > 256 || dtype != 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)oh * ow >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  Maps p;
  for (int v = 0; v < kMaxMaps; ++v) p.m[v] = Map{nullptr, 1, 1, 1, 0, 0, 1.0, 1.0};
  for (int v = 0; v < n; ++v) {
    const int* d = dims + 5 * v;
    p.m[v] = Map{static_cast<const float*>(maps[v]), d[0], d[1], d[2], d[3], d[4],
                 scales[2 * v], scales[2 * v + 1]};
  }
  p.n = n;
  const int npix = oh * ow;
  if (npix == 0) return 0;
  size_t smem;
  const int status = staged_smem(tta_merge_kernel, C, &smem);
  if (status) return status;
  tta_merge_kernel<<<(npix + kBlock - 1) / kBlock, kBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(avg), static_cast<uint8_t*>(argmax), oh, ow, C);
  return (int)cudaGetLastError();
}

// src (sh, sw, C) float32 resized to (ch, cw) into out (qh, qw, C), zero
// outside the content; sy, sx, area as in tta_merge; ch <= qh, cw <= qw.
int tta_resample(const void* src, void* out, int sh, int sw, int qh, int qw, int ch, int cw,
                 int C, double sy, double sx, int area, int dtype, void* stream) {
  if (C < 1 || dtype != 0 || ch > qh || cw > qw) return (int)cudaErrorInvalidValue;
  if ((int64_t)qh * qw >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const Map m{static_cast<const float*>(src), sh, sw, sw, 0, area, sy, sx};
  const int npix = qh * qw;
  if (npix == 0) return 0;
  size_t smem;
  const int status = staged_smem(tta_resample_kernel, C, &smem);
  if (status) return status;
  tta_resample_kernel<<<(npix + kBlock - 1) / kBlock, kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      m, static_cast<float*>(out), qh, qw, ch, cw, C);
  return (int)cudaGetLastError();
}

// frame (h, w, 3) uint8 BGR, h * w * 3 < 2^31; canvas (bh, bw, 3) float32
// (dtype 0) or bf16 (1), 16-byte aligned, bh * bw * 3 < 2^31; the content
// (rh, rw) >= 1; sy, sx, area as in tta_merge for (h, w) -> (rh, rw); flip
// mirrors the resized image; m0, m1, m2 the means subtracted from B, G, R.
int tta_sample(const void* frame, void* canvas, int h, int w, int rh, int rw, int bh, int bw,
               double sy, double sx, int area, int flip, float m0, float m1, float m2,
               int dtype, void* stream) {
  if (h < 1 || w < 1 || rh < 1 || rw < 1 || bh < 1 || bw < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)h * w * 3 >= ((int64_t)1 << 31) || (int64_t)bh * bw * 3 >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(canvas) % 16) return (int)cudaErrorMisalignedAddress;
  const Map m{nullptr, h, w, w, 0, area, sy, sx};
  const Means mean{{m0, m1, m2}};
  const int ch = rh < bh ? rh : bh, cw = rw < bw ? rw : bw, npix = bh * bw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_sample<float>(frame, canvas, m, ch, cw, rw, bw, npix, flip, mean, s)
                    : launch_sample<__nv_bfloat16>(frame, canvas, m, ch, cw, rw, bw, npix, flip,
                                                   mean, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
