// The per-tap rounding of the training forwards (K2 in deform_sample.cu,
// K6 in deform_sample_tiled.cu), which reproduces a chain of per-tap samples
// added in y's dtype in tap order, as the JAX training form adds them.
//
// A tap's value is the f32 sum of sample_tap_hoisted (sample_tap.cuh). The
// chain is what a loop of per-tap samples and PyTorch adds computes: out =
// tap_0, then out = round(float(out) + float(tap_t)), each tap rounded to T
// first (a bf16 add on the card computes in f32 and rounds to nearest
// even). So a kernel gives the values of the nine samples and eight adds it
// replaces.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float round_to(float x);

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

// One link of the chain: tap t's f32 sum of 8 channels `tap` into the
// running value `res`.
template <typename T>
__device__ __forceinline__ void chain_add(int t, const float* tap, float* res) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = round_to<T>(tap[k]);
    res[k] = t == 0 ? v : round_to<T>(res[k] + v);
  }
}
