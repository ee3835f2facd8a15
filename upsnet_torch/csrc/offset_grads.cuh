// The coordinate gradients of a K-tap deformable bilinear sampler, shared by
// K8c (deform_shift.cu, the shift route's one-matmul layout), the
// coordinate pass of both K3 forms (deform_sample_bwd.cu, side-by-side
// layout) and of K7b (deform_sample_mt_bwd.cu: one input x
// for every tap, at tap stride 0, and a g row per (pixel, tap)).
//
// With tap t's map of image b at y + b * img_stride + t * tap_stride, pixel
// (r, q) of it at (r * W + q) * pix_stride, the upstream gradient of tap t
// at output pixel n = (b * H + i) * W + j at g + n * g_pix + t * g_tap, and
// hat weights vy_r = max(0, 1 - |sy - r|), vx_q = max(0, 1 - |sx - q|) under
// DCNv1 zero padding (a sample counts iff it lies in (-1, H) x (-1, W); rows
// and columns outside the map read zero):
//
//   gsy[t, b, i, j] = sum_c g_t[b, i, j, c] * sum_{r, q} dvy_r *  vx_q * y_t[b, r, q, c]
//   gsx[t, b, i, j] = sum_c g_t[b, i, j, c] * sum_{r, q}  vy_r * dvx_q * y_t[b, r, q, c]
//
// where dv, the derivative of a node's hat weight, follows one of three
// rules, each the derivative of the JAX function that a route stands for:
//
//   kPallas  the Pallas backward kernels (_sample_pallas_bwd and the tiled,
//            shift and mt ones): dv = -sign(d) where |d| < 1, else 0, so
//            every derivative is exactly 0 at an integer coordinate (d = 0 at
//            the peak, |d| = 1 at its neighbours);
//   kHat     autodiff of max(0, 1 - |d|) (deform_conv2d_mxu): as kPallas off
//            the grid; at an integer coordinate r, abs' is +1 at 0 and each
//            maximum's tie takes half, so dv is -0.5, -1, +0.5 at r - 1, r,
//            r + 1 (per axis 0.5 v[r + 1] - v[r] - 0.5 v[r - 1]);
//   kFloor   autodiff of the floor-based corner weights
//            (deform_conv2d_batched): -1 at the low node, +1 at the high one,
//            also at an integer coordinate (per axis v[r + 1] - v[r]).
//
// A launch may also name a device flag (`fast`): where it reads 0 the kernel
// takes kFloor instead of its rule, as the JAX `auto` route's lax.cond falls
// back to the gather form, with no host sync. K3 and K8c read one g for all
// taps (g_tap 0, g_pix C); K7b one per tap (g_tap C, g_pix K * C). K8c and
// K7b take kPallas.
//
// A sub-warp of WIDTH lanes owns a pixel (16 at C 128, the least power of
// two >= C / 8, at most 32), a lane a group of 8 channels, as in K1: the
// lane loads its 8 channels of g once (per tap where g_tap is not 0, as it
// does per group where C > 256), then walks the taps with the next
// tap's coordinates in flight, issues the raw words of a tap's four corners
// before it uses any (predicated loads, none behind a branch; under kHat two
// more nodes after them at an integer coordinate; tap_frac of
// sample_tap.cuh gives the corners and their distances) and stores its two
// partial sums of the tap in shared memory. After the taps of a chunk (up to
// kChunk = 9, a 3 x 3 layer's taps) a thread per (tap, gy or gx, pixel) sums
// the WIDTH partials in lane order and writes them, neighbouring pixels
// together. Nothing is carried across taps in registers and no shuffle
// chain sits between two taps' loads, so a thread needs about as many
// registers as K1 (60 at bf16) and an SM holds as many threads. Fixed order
// throughout, so two runs give the same bits; no atomics. Bound by the bytes
// of y (the touched corners), read with 16-byte loads along C through L1/L2:
// a block's footprint at reach 7 (16 rows of 48 pixels, 2304 B a pixel side
// by side) does not fit shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sample_tap.cuh"
#include "vec8.cuh"

namespace offset_grads {

constexpr int kBlock = 256;  // threads a block: a multiple of every WIDTH
constexpr int kChunk = 9;    // taps a pass over shared memory takes

// The rules of the coordinate derivative (above).
constexpr int kPallas = 0, kHat = 1, kFloor = 2;

// The dot products of one node's 8 channels with g, added to gy and gx with
// the node's weights.
template <typename T>
__device__ __forceinline__ void add_node(const Raw8<T>& raw, const float* gv, float wy,
                                         float wx, float& gy, float& gx) {
  float v[8];
  widen8(raw, v);
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) dot = fmaf(gv[k], v[k], dot);
  gy = fmaf(wy, dot, gy);
  gx = fmaf(wx, dot, gx);
}

// One tap of one group of 8 channels: this lane's share of the two
// coordinate gradients under RULE, added to gy and gx. The four corners'
// loads are issued before any is used, and predicated: a sample that does
// not count, or a corner outside the map, loads nothing and adds nothing.
// Under kHat a sample with an integer coordinate then loads two more nodes,
// the nodes below the low one on that axis beside the corners that weigh on
// them (with both coordinates integers, (y0 - 1, x0) and (y0, x0 - 1)):
// after the corners, so that their registers are free again and a sample
// off the grid pays only the test.
template <typename T, int RULE>
__device__ __forceinline__ void tap_grad(const T* tap, float sy, float sx, int H, int W,
                                         int64_t stride, const float* gv, float& gy,
                                         float& gx) {
  int y0 = 0, x0 = 0;
  float ly = 0.f, lx = 0.f;
  const bool inside = tap_frac(sy, sx, H, W, &y0, &x0, &ly, &lx);
  const float hy = 1.f - ly, hx = 1.f - lx;
  // dv at the low node and at the high one: -1 and +1, except kPallas at an
  // integer (0 at both) and kHat at an integer (+0.5 at the high node)
  const float dy0 = RULE != kPallas || ly > 0.f ? -1.f : 0.f;
  const float dx0 = RULE != kPallas || lx > 0.f ? -1.f : 0.f;
  const bool iy = RULE == kHat && ly == 0.f, ix = RULE == kHat && lx == 0.f;
  const float dy1 = iy ? 0.5f : -dy0, dx1 = ix ? 0.5f : -dx0;
  // corner order (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1):
  // wy = dvy * vx, wx = vy * dvx
  const float wy[4] = {dy0 * hx, dy0 * lx, dy1 * hx, dy1 * lx};
  const float wx[4] = {hy * dx0, hy * dx1, ly * dx0, ly * dx1};
  Raw8<T> raw[4];
  bool ok[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = y0 + (q >> 1), xx = x0 + (q & 1);
    ok[q] = inside && yy >= 0 && yy < H && xx >= 0 && xx < W;
    if (ok[q]) raw[q] = ldg8(tap + ((int64_t)yy * W + xx) * stride);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (ok[q]) add_node(raw[q], gv, wy[q], wx[q], gy, gx);
  }
  if constexpr (RULE == kHat) {
    if (inside && (iy || ix)) {
      // dv = -0.5 at the node below the low one, on an integer axis
      const int ny[2] = {iy ? y0 - 1 : y0, ix ? (iy ? y0 : y0 + 1) : y0 - 1};
      const int nx[2] = {iy ? x0 : x0 - 1, ix ? x0 - 1 : x0 + 1};
      const float ey[2] = {iy ? -0.5f * hx : 0.f, ix ? 0.f : -0.5f * lx};
      const float ex[2] = {iy ? 0.f : -0.5f * hy, ix ? -0.5f * (iy ? hy : ly) : 0.f};
      Raw8<T> more[2];
      bool in_map[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        in_map[q] = ny[q] >= 0 && ny[q] < H && nx[q] >= 0 && nx[q] < W;
        if (in_map[q]) more[q] = ldg8(tap + ((int64_t)ny[q] * W + nx[q]) * stride);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (in_map[q]) add_node(more[q], gv, ey[q], ex[q], gy, gx);
      }
    }
  }
}

// The partial sums of a block of kBlock / WIDTH pixels: one array a WIDTH,
// shared by the rules' bodies of one kernel.
template <int WIDTH>
__device__ __forceinline__ float* partials() {
  __shared__ float part[2 * (kBlock / WIDTH) * (kChunk * WIDTH + 1)];
  return part;
}

// The body of a kernel over blocks of kBlock / WIDTH pixels (the kernels of
// K3 and K8c below, K7b's in deform_sample_mt_bwd.cu) under rule RULE.
// G_PER_TAP: g is read per tap (g_tap not 0); else once a pixel, at g_pix = C.
template <typename T, int WIDTH, bool G_PER_TAP, int RULE>
__device__ __forceinline__ void body(const T* __restrict__ y, const float* __restrict__ sy,
                                     const float* __restrict__ sx, const T* __restrict__ g,
                                     float* __restrict__ gsy, float* __restrict__ gsx, int K,
                                     int B, int H, int W, int C, int64_t img_stride,
                                     int64_t tap_stride, int64_t pix_stride, int64_t g_tap,
                                     int64_t g_pix) {
  constexpr int kPix = kBlock / WIDTH;      // pixels a block owns
  constexpr int kRow = kChunk * WIDTH + 1;  // a pixel's partial sums, padded against conflicts
  float* const part = partials<WIDTH>();   // gy, then gx: [pixel][tap][lane]
  const int groups = C / 8;
  const bool many = groups > WIDTH;  // a lane owns several groups (C > 256)
  const int64_t plane = (int64_t)B * H * W;
  const int p = threadIdx.x / WIDTH, lane = threadIdx.x % WIDTH;
  const int64_t pix0 = (int64_t)blockIdx.x * kPix;
  const int64_t pix = pix0 + p;  // (b * H + i) * W + j
  const bool live = pix < plane;
  const int b = live ? (int)(pix / ((int64_t)H * W)) : 0;
  const T* img = y + (int64_t)b * img_stride;
  const T* g_pix0 = g + pix * g_pix;
  float gv[8];
  if (live && !many && !G_PER_TAP && lane < groups) load8(g_pix0 + lane * 8, gv);
  // every thread of the block reaches the barriers, so no early return
  for (int t0 = 0; t0 < K; t0 += kChunk) {
    const int n = min(kChunk, K - t0);
    float py = live ? __ldg(sy + t0 * plane + pix) : -2.f;  // -2: does not count
    float px = live ? __ldg(sx + t0 * plane + pix) : -2.f;
    for (int u = 0; u < n; ++u) {
      const float cy = py, cx = px;
      if (live && u + 1 < n) {  // in flight while this tap is summed
        py = __ldg(sy + (t0 + u + 1) * plane + pix);
        px = __ldg(sx + (t0 + u + 1) * plane + pix);
      }
      float gy = 0.f, gx = 0.f;
      for (int grp = lane; live && grp < groups; grp += WIDTH) {
        if (many || G_PER_TAP) load8(g_pix0 + (t0 + u) * g_tap + grp * 8, gv);
        tap_grad<T, RULE>(img + (t0 + u) * tap_stride + grp * 8, cy, cx, H, W, pix_stride, gv,
                          gy, gx);
      }
      part[p * kRow + u * WIDTH + lane] = gy;
      part[kPix * kRow + p * kRow + u * WIDTH + lane] = gx;
    }
    __syncthreads();
    // a thread per (tap, gy or gx, pixel), the pixel fastest: the sum over
    // the lanes in lane order, written with its neighbours' pixels
    for (int i = threadIdx.x; i < 2 * n * kPix; i += kBlock) {
      const int q = i % kPix, comp = (i / kPix) & 1, u = i / (2 * kPix);
      const float* src = part + (comp * kPix + q) * kRow + u * WIDTH;
      float sum = 0.f;
#pragma unroll
      for (int l = 0; l < WIDTH; ++l) sum += src[l];
      if (pix0 + q < plane) (comp ? gsx : gsy)[(t0 + u) * plane + pix0 + q] = sum;
    }
    __syncthreads();
  }
}

// The one-g kernel: K8c and the all-tap K3's coordinate pass, under RULE;
// FLAGGED: under kFloor where the device flag `fast` reads 0 (one load a
// thread, the same value in the whole grid: no thread diverges).
template <typename T, int WIDTH, int RULE, bool FLAGGED>
__global__ void __launch_bounds__(kBlock)
offset_grads_kernel(const T* __restrict__ y, const float* __restrict__ sy,
                    const float* __restrict__ sx, const T* __restrict__ g,
                    float* __restrict__ gsy, float* __restrict__ gsx,
                    int K, int B, int H, int W, int C,
                    int64_t img_stride, int64_t tap_stride, int64_t pix_stride,
                    const uint8_t* __restrict__ fast) {
  if (FLAGGED && !__ldg(fast)) {
    body<T, WIDTH, false, kFloor>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img_stride,
                                  tap_stride, pix_stride, 0, C);
  } else {
    body<T, WIDTH, false, RULE>(y, sy, sx, g, gsy, gsx, K, B, H, W, C, img_stride, tap_stride,
                                pix_stride, 0, C);
  }
}

// Blocks of a launch over the B * H * W pixels at sub-warp width WIDTH.
inline unsigned grid(int B, int H, int W, int width) {
  const int64_t threads = (int64_t)B * H * W * width;
  return (unsigned)((threads + kBlock - 1) / kBlock);
}

}  // namespace offset_grads

// Calls f(std::integral_constant<int, WIDTH>()) with the sub-warp width for
// C channels: the least power of two >= C / 8 lanes, at most 32 (a lane
// takes several groups only when C > 256).
template <typename F>
void with_width(int C, F&& f) {
  const int groups = C / 8;
  if (groups <= 1) f(std::integral_constant<int, 1>());
  else if (groups <= 2) f(std::integral_constant<int, 2>());
  else if (groups <= 4) f(std::integral_constant<int, 4>());
  else if (groups <= 8) f(std::integral_constant<int, 8>());
  else if (groups <= 16) f(std::integral_constant<int, 16>());
  else f(std::integral_constant<int, 32>());
}

// Launches offset_grads_kernel over the B * H * W pixels on stream s under
// `rule` (kPallas, kHat or kFloor), and where `fast` is not null under kFloor
// when the device flag it points to reads 0. Returns cudaErrorInvalidValue
// for another rule.
template <typename T>
int launch_offset_grads(const void* y, const void* sy, const void* sx, const void* g,
                        void* gsy, void* gsx, int K, int B, int H, int W, int C,
                        int64_t img_stride, int64_t tap_stride, int64_t pix_stride, int rule,
                        const void* fast, cudaStream_t s) {
  if (rule != offset_grads::kPallas && rule != offset_grads::kHat &&
      rule != offset_grads::kFloor) {
    return (int)cudaErrorInvalidValue;
  }
  with_width(C, [&](auto width) {
    constexpr int WIDTH = decltype(width)::value;
    using offset_grads::kFloor;
    using offset_grads::kHat;
    using offset_grads::kPallas;
    auto kernel = offset_grads::offset_grads_kernel<T, WIDTH, kPallas, false>;
    if (fast == nullptr || rule == kFloor) {
      if (rule == kHat) kernel = offset_grads::offset_grads_kernel<T, WIDTH, kHat, false>;
      if (rule == kFloor) kernel = offset_grads::offset_grads_kernel<T, WIDTH, kFloor, false>;
    } else {
      kernel = rule == kHat ? offset_grads::offset_grads_kernel<T, WIDTH, kHat, true>
                            : offset_grads::offset_grads_kernel<T, WIDTH, kPallas, true>;
    }
    kernel<<<offset_grads::grid(B, H, W, WIDTH), offset_grads::kBlock, 0, s>>>(
        static_cast<const T*>(y), static_cast<const float*>(sy), static_cast<const float*>(sx),
        static_cast<const T*>(g), static_cast<float*>(gsy), static_cast<float*>(gsx), K, B, H,
        W, C, img_stride, tap_stride, pix_stride, static_cast<const uint8_t*>(fast));
  });
  return (int)cudaGetLastError();
}
