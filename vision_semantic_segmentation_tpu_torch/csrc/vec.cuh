// float32 / bfloat16 channels as f32 registers: the conversions, the number
// of channels in a 16-byte copy (Vec<T>::N), f32 weight loads and the test
// for the 16-byte path.  Shared by the depthwise kernels (phase.cuh,
// aspp_depthwise.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// V f32 weights of one tap: w points at the tap's (C,) row, offset by c.
template <int V>
__device__ __forceinline__ void load_weights(const float* __restrict__ w, float* v) {
  if constexpr (V == 1) {
    v[0] = w[0];
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) Vec<float>::load(w + k, v + k);
  }
}

// Whether every pointer is 16-byte aligned and C fills whole vectors.
inline bool vector_ok(int C, int n, const void* const* ptrs, int count) {
  if (C % n != 0) return false;
  for (int i = 0; i < count; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  return true;
}
