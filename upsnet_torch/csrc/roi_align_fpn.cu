// K4: FPN ROIAlign forward over the P2..P5 pyramid, Detectron clamp.
//
// out[b, r, ph, pw, :] = mean over the S x S samples of bin (ph, pw) of RoI
// (b, r) of the bilinear value of its level's map, with the Detectron
// semantics of upsnet_tpu/ops/roi_align.py: no half-pixel shift,
// roi_w = max(x2 - x1, 1) after scaling, samples outside [-1, H] x [-1, W]
// count zero, coordinates clamp below at 0 and snap to the last row/column.
// Replaces the TPU kernel upsnet_tpu/ops/roi_align_pallas.py:
// fpn_roi_align_window (_window_kernel).
//
// One block per RoI; its threads stride over (bin, group of 8 channels). A
// corner is one 16-byte load (bf16) or two (f32) along contiguous channels;
// sums are f32 and rounded once. The RoI reads its own level directly, so
// no window, strip loop or level padding is needed. The work is bound by
// the feature bytes the samples touch and the output bytes.
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

template <typename T>
__device__ __forceinline__ void add_corner(const T* p, float wgt, float* acc) {
  float v[8];
  load8(p, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = fmaf(wgt, v[k], acc[k]);
}

struct Level {
  const void* feat;
  int h, w;
  float scale;
};

struct Pyramid {
  Level lv[4];
};

template <typename T>
__global__ void __launch_bounds__(256)
fpn_roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                     const int* __restrict__ levels, T* __restrict__ out,
                     int R, int C, int P, int S) {
  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  int l = levels[roi];
  l = l < 0 ? 0 : (l > 3 ? 3 : l);
  const Level lv = pyr.lv[l];
  const int H = lv.h, W = lv.w;
  const float Hf = (float)H, Wf = (float)W;
  const T* feat = static_cast<const T*>(lv.feat) + (int64_t)b * H * W * C;

  const float x1 = __fmul_rn(rois[roi * 4 + 0], lv.scale);
  const float y1 = __fmul_rn(rois[roi * 4 + 1], lv.scale);
  const float x2 = __fmul_rn(rois[roi * 4 + 2], lv.scale);
  const float y2 = __fmul_rn(rois[roi * 4 + 3], lv.scale);
  const float inv_p = __fdiv_rn(1.f, (float)P);
  const float bin_w = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 1.f), inv_p);
  const float bin_h = __fmul_rn(fmaxf(__fsub_rn(y2, y1), 1.f), inv_p);
  const float inv_ss = 1.f / (float)(S * S);

  const int groups = C / 8;
  const int items = P * P * groups;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int g = it % groups;
    const int bin = it / groups;
    const int ph = bin / P, pw = bin % P;
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int iy = 0; iy < S; ++iy) {
      const float fy = __fadd_rn((float)ph, __fdiv_rn((float)iy + 0.5f, (float)S));
      const float y = __fmaf_rn(fy, bin_h, y1);
      for (int ix = 0; ix < S; ++ix) {
        const float fx = __fadd_rn((float)pw, __fdiv_rn((float)ix + 0.5f, (float)S));
        const float x = __fmaf_rn(fx, bin_w, x1);
        if (y < -1.f || y > Hf || x < -1.f || x > Wf) continue;
        float yc = fmaxf(y, 0.f), xc = fmaxf(x, 0.f);
        int yl = (int)floorf(yc), xl = (int)floorf(xc);
        int yh, xh;
        if (yl >= H - 1) { yl = yh = H - 1; yc = (float)yl; } else { yh = yl + 1; }
        if (xl >= W - 1) { xl = xh = W - 1; xc = (float)xl; } else { xh = xl + 1; }
        const float ly = yc - (float)yl, lx = xc - (float)xl;
        const float hy = 1.f - ly, hx = 1.f - lx;
        const T* base = feat + g * 8;
        add_corner(base + ((int64_t)yl * W + xl) * C, hy * hx, acc);
        add_corner(base + ((int64_t)yl * W + xh) * C, hy * lx, acc);
        add_corner(base + ((int64_t)yh * W + xl) * C, ly * hx, acc);
        add_corner(base + ((int64_t)yh * W + xh) * C, ly * lx, acc);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] *= inv_ss;
    store8(out + ((int64_t)roi * P * P + bin) * C + g * 8, acc);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. f0..f3 are the (B, H_l, W_l, C) levels,
// rois (B, R, 4) f32, levels (B, R) int32, out (B, R, P, P, C).
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
  const unsigned grid = (unsigned)B * (unsigned)R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (dtype == 1) {
      fpn_roi_align_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<__nv_bfloat16*>(out), R, C, P, S);
    } else {
      fpn_roi_align_kernel<float><<<grid, 256, 0, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<float*>(out), R, C, P, S);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
