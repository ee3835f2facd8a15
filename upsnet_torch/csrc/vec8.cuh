// 8-channel vector loads, stores and atomic adds shared by the port's
// kernels: one 16-byte load (bf16) or two (f32) of channels [c, c + 8),
// widened to f32, the matching round-to-nearest store, and the f32 canvas add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The raw 16-byte words of channels [c, c + 8), loaded before they are
// widened, so that a thread can hold several loads in flight at the cost of
// 4 (bf16) or 8 (f32) registers each.
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 w;
};

template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ Raw8<__nv_bfloat16> ldg8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ Raw8<float> ldg8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

// bf16 to f32 is exact: the bf16 bits are the f32's high half. One shift or
// mask a channel: on the H100 the all-tap samplers ran 3-5% slower with
// __bfloat1622float2.
__device__ __forceinline__ void widen8(const Raw8<__nv_bfloat16>& r, float* v) {
  const uint32_t u[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // channel 2k in the low half, 2k + 1 in the high
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen8(const Raw8<float>& r, float* v) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  widen8(ldg8(p), v);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[c .. c + 8) += v in an f32 canvas, as two 16-byte vector atomics
// (sm_90); p must be 16-byte aligned. The order of concurrent adds is not
// fixed, so sums differ between runs by f32 rounding.
__device__ __forceinline__ void atomic_add8(float* p, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
