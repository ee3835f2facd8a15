// K8b: gradient of the fused K-tap sampler (K8a, deform_shift.cu) to its
// projection map, as a gather.
//
// With the hat weights vy = max(0, 1 - |sy - R|), vx = max(0, 1 - |sx - Q|)
// and the inside mask m (a sample counts iff it lies in (-1, H) x (-1, W)),
// source element (R, Q) of tap t receives from every output pixel (i, j)
// whose hats reach it:
//
//   gy[b, R, Q, t * C + c] = sum_{i, j} vy(sy[t, b, i, j] - R) * vx(sx[t, b, i, j] - Q)
//                                       * m[t, b, i, j] * g[b, i, j, c]
//
// It replaces the TPU kernel upsnet_tpu/ops/deform_shift_pallas.py:
// _shift_adjoint (_shift_adj_kernel) and keeps the property that defines it:
// every element of gy is summed in f32 in a fixed order and written exactly
// once, in g's dtype. No float atomics, no f32 canvas, no zero-fill or cast
// pass, and the same bits on every run.
//
// The caller bounds the offsets: |sy - i| <= ry and |sx - j| <= rx for every
// counted sample, so the output pixels that can reach (R, Q) lie in the box
// i in [R - ry, R + ry], j in [Q - rx, Q + rx] (15 x 15 at max_dy 6,
// dilation 1). The TPU kernel walks the same box as static (row candidate,
// column shift) slabs of padded field planes in VMEM; here a block owns a
// tile of 8 x 32 source pixels of one tap and one image, stages the two
// coordinate fields of the tile's halo in shared memory (a masked or
// out-of-map pixel as a value no hat reaches), and a sub-warp of `width`
// lanes owns one source pixel at a time: its lanes test `width` candidates
// of one row of the box at once, a ballot collects the hits, and for each
// hit in ascending (row, column) order every lane adds weight * g over its
// own 8 channels in registers. About 4 candidates of the box hit; the tests
// cost shared-memory reads only. Bound by bytes: gy written once (K * C
// values per pixel), g and the fields read.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTileH = 8, kTileW = 32;  // kTileH * kTileW == kBlock source pixels
constexpr float kUnreached = 3.0e38f;   // no hat reaches this coordinate
constexpr size_t kMaxShared = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kBlock)
shift_adjoint_kernel(const T* __restrict__ g, const float* __restrict__ sy,
                     const float* __restrict__ sx, T* __restrict__ gy,
                     int K, int B, int H, int W, int C, int ry, int rx, int width,
                     int tiles_x) {
  extern __shared__ float fields[];
  const int box_h = 2 * ry + 1, box_w = 2 * rx + 1;
  const int halo_h = kTileH + 2 * ry, halo_w = kTileW + 2 * rx;
  float* fy = fields;
  float* fx = fields + halo_h * halo_w;
  const int t = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / tiles_x) * kTileH, q0 = (blockIdx.x % tiles_x) * kTileW;

  const float* sy_tb = sy + ((int64_t)t * B + b) * H * W;
  const float* sx_tb = sx + ((int64_t)t * B + b) * H * W;
  for (int idx = threadIdx.x; idx < halo_h * halo_w; idx += kBlock) {
    const int i = r0 - ry + idx / halo_w, j = q0 - rx + idx % halo_w;
    float vy = kUnreached, vx = kUnreached;
    if (i >= 0 && i < H && j >= 0 && j < W) {
      const float py = __ldg(sy_tb + (int64_t)i * W + j);
      const float px = __ldg(sx_tb + (int64_t)i * W + j);
      if (py > -1.f && py < (float)H && px > -1.f && px < (float)W) {
        vy = py;
        vx = px;
      }
    }
    fy[idx] = vy;
    fx[idx] = vx;
  }
  __syncthreads();

  const int groups = C / 8;
  const int lane = threadIdx.x % width;
  const int sub = threadIdx.x / width, n_sub = kBlock / width;
  // the lanes of this sub-warp within its warp; ballots and shuffles name
  // only them, so sub-warps of one warp never wait for each other
  const unsigned first = (threadIdx.x & 31u) & ~(unsigned)(width - 1);
  const unsigned sub_mask = (width == 32 ? 0xffffffffu : ((1u << width) - 1u)) << first;
  const T* g_b = g + (int64_t)b * H * W * C;

  for (int base = 0; base < groups; base += width) {  // one pass while C <= 8 * width
    const int grp = base + lane;
    for (int p = sub; p < kTileH * kTileW; p += n_sub) {
      const int pr = p / kTileW, pq = p % kTileW;
      const int R = r0 + pr, Q = q0 + pq;
      const bool live = R < H && Q < W;
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      for (int di = 0; di < box_h; ++di) {
        const int row_at = (pr + di) * halo_w + pq;
        for (int dj0 = 0; dj0 < box_w; dj0 += width) {  // one pass while box_w <= width
          const int dj = dj0 + lane;
          float wgt = 0.f;
          if (live && dj < box_w) {
            const float wy = 1.f - fabsf(fy[row_at + dj] - (float)R);
            const float wx = 1.f - fabsf(fx[row_at + dj] - (float)Q);
            if (wy > 0.f && wx > 0.f) wgt = wy * wx;
          }
          unsigned hits = __ballot_sync(sub_mask, wgt > 0.f) >> first;
          while (hits) {  // ascending (row, column): a fixed order of the sum
            const int bit = __ffs(hits) - 1;
            hits &= hits - 1;
            const float w_hit = __shfl_sync(sub_mask, wgt, bit, width);
            if (grp < groups) {
              const int i = R - ry + di, j = Q - rx + dj0 + bit;
              float v[8];
              load8(g_b + ((int64_t)i * W + j) * C + grp * 8, v);
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[k] = fmaf(w_hit, v[k], acc[k]);
            }
          }
        }
      }
      if (live && grp < groups) {
        store8(gy + ((((int64_t)b * H + R) * W + Q) * K + t) * C + grp * 8, acc);
      }
    }
  }
}

template <typename T>
void launch(const void* g, const void* sy, const void* sx, void* gy, int K, int B, int H,
            int W, int C, int ry, int rx, size_t shared, cudaStream_t s) {
  const int groups = C / 8;
  int width = 1;
  while (width < groups && width < 32) width *= 2;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)K, (unsigned)B);
  shift_adjoint_kernel<T><<<grid, kBlock, shared, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(sy),
      static_cast<const float*>(sx), static_cast<T*>(gy), K, B, H, W, C, ry, rx, width,
      tiles_x);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of g and gy). g (B, H, W, C); sy, sx
// (K, B, H, W) f32 with |sy - i| <= ry and |sx - j| <= rx at every counted
// sample; gy (B, H, W, K * C), every element written. K and B at most 65535;
// the halo's fields must fit 48 KB of shared memory.
int shift_adjoint(const void* g, const void* sy, const void* sx, void* gy, int K, int B,
                  int H, int W, int C, int ry, int rx, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t shared =
      2 * sizeof(float) * (size_t)(kTileH + 2 * ry) * (size_t)(kTileW + 2 * rx);
  if (ry < 0 || rx < 0 || shared > kMaxShared || K > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)B * H * W > 0 && C >= 8 && K > 0) {
    if (dtype == 1) launch<__nv_bfloat16>(g, sy, sx, gy, K, B, H, W, C, ry, rx, shared, s);
    else launch<float>(g, sy, sx, gy, K, B, H, W, C, ry, rx, shared, s);
  }
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
