// 16-byte vector loads and stores of float32 / bfloat16 channels, converted
// to and from f32 registers.  Shared by the depthwise kernels (depthwise.cu,
// aspp_depthwise.cu, depthwise_hoist.cu): each thread owns Vec<T>::N
// channels (16 bytes) of one pixel, so neighbouring threads touch
// neighbouring 16-byte words.
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
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
};

// V channels of pixel (r, cc) starting at channel c, as f32; zeros outside the
// image (the zero padding).  V is Vec<T>::N for the 16-byte path, 1 for the
// scalar one.
template <typename T, int V>
__device__ __forceinline__ void load_pixel(const T* __restrict__ x, int H, int W, int C,
                                           int r, int cc, int c, float* v) {
  if (r >= 0 && r < H && cc >= 0 && cc < W) {
    const T* src = x + (static_cast<int64_t>(r) * W + cc) * C + c;
    if constexpr (V == 1) {
      v[0] = Vec<T>::to_float(src[0]);
    } else {
      Vec<T>::load(src, v);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.0f;
  }
}

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

template <typename T, int V>
__device__ __forceinline__ void store_pixel(T* __restrict__ dst, const float* v) {
  if constexpr (V == 1) {
    dst[0] = Vec<T>::from_float(v[0]);
  } else {
    Vec<T>::store(dst, v);
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
