// K5: backward of the FPN ROIAlign forward (K4) to the four level maps.
//
// The forward averages the S x S bilinear samples of each bin, so the
// gradient of bin (ph, pw) of RoI (b, r), divided by S * S, goes to each of
// its samples and from there to the sample's four corners with the
// forward's weights and Detectron clamps (samples outside [-1, H] x [-1, W]
// count zero, coordinates clamp below at 0 and snap to the last row or
// column). RoIs and levels get no gradient. Replaces the TPU kernel
// upsnet_tpu/ops/roi_align_pallas.py:fpn_roi_align_window_bwd
// (_window_bwd_kernel).
//
// One block per RoI; its threads stride over (bin, group of 8 channels),
// read the bin's gradient with one 16-byte load (bf16) or two (f32) and
// scatter it with vector atomics into the RoI's level canvas: four zeroed
// f32 canvases, one per level, because RoIs overlap and bf16 has no cheap
// scalar atomic. The order of the adds is not fixed, so the sums differ
// between runs by f32 rounding. A bin whose gradient is all zero adds
// nothing and is skipped. The window DMA, strip loop and padded small
// levels of the TPU kernel have no counterpart here. The work is bound by
// the bytes of the gradient read and of the canvases written.
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

struct Level {
  float* canvas;
  int h, w;
  float scale;
};

struct Pyramid {
  Level lv[4];
};

__device__ __forceinline__ void scatter_corner(float* p, float wgt, const float* g) {
  if (wgt == 0.f) return;
  float add[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) add[k] = wgt * g[k];
  atomic_add8(p, add);
}

template <typename T>
__global__ void __launch_bounds__(256)
fpn_roi_align_bwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                         const int* __restrict__ levels, const T* __restrict__ grad,
                         int R, int C, int P, int S) {
  const int roi = blockIdx.x;  // b * R + r
  const int b = roi / R;
  int l = levels[roi];
  l = l < 0 ? 0 : (l > 3 ? 3 : l);
  const Level lv = pyr.lv[l];
  const int H = lv.h, W = lv.w;
  const float Hf = (float)H, Wf = (float)W;
  float* canvas = lv.canvas + (int64_t)b * H * W * C;

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
    float gv[8];
    load8(grad + ((int64_t)roi * P * P + bin) * C + g * 8, gv);
    bool any = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      any |= gv[k] != 0.f;
      gv[k] *= inv_ss;
    }
    // padded RoI slots carry no gradient, and their identical boxes would
    // serialise thousands of adds on one pixel
    if (!any) continue;
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
        float* base = canvas + g * 8;
        scatter_corner(base + ((int64_t)yl * W + xl) * C, hy * hx, gv);
        scatter_corner(base + ((int64_t)yl * W + xh) * C, hy * lx, gv);
        scatter_corner(base + ((int64_t)yh * W + xl) * C, ly * hx, gv);
        scatter_corner(base + ((int64_t)yh * W + xh) * C, ly * lx, gv);
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of grad). c0..c3 are the zeroed f32
// canvases (B, H_l, W_l, C), rois (B, R, 4) f32, levels (B, R) int32, grad
// (B, R, P, P, C).
int fpn_roi_align_bwd(void* c0, void* c1, void* c2, void* c3, const void* rois,
                      const void* levels, const void* grad, int B, int R, int C, int P,
                      int S, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
                      int w3, float sc0, float sc1, float sc2, float sc3, int dtype,
                      void* stream) {
  Pyramid pyr;
  pyr.lv[0] = Level{static_cast<float*>(c0), h0, w0, sc0};
  pyr.lv[1] = Level{static_cast<float*>(c1), h1, w1, sc1};
  pyr.lv[2] = Level{static_cast<float*>(c2), h2, w2, sc2};
  pyr.lv[3] = Level{static_cast<float*>(c3), h3, w3, sc3};
  const unsigned grid = (unsigned)B * (unsigned)R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (dtype == 1) {
      fpn_roi_align_bwd_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<const __nv_bfloat16*>(grad), R, C, P, S);
    } else {
      fpn_roi_align_bwd_kernel<float><<<grid, 256, 0, s>>>(
          pyr, static_cast<const float*>(rois), static_cast<const int*>(levels),
          static_cast<const float*>(grad), R, C, P, S);
    }
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
