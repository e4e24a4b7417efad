// Dilated depthwise 3x3 convolution for Hopper (sm_90a): stride 1, zero pad
// = dilation, NHWC, f32 accumulation, output in the input dtype.
//
// Replaces the TPU kernel vision_semantic_segmentation_tpu/ops/pallas/
// depthwise.py :: depthwise3x3_dilated (bodies _kernel, _kernel_slab_f32).
// Arithmetic order is that kernel's: taps in row-major order (ti, then tj),
// each term x * w rounded in f32, the first term starting the sum, each
// later term added with a rounded f32 add (explicit intrinsics: no FMA
// contraction).  Out-of-image taps contribute 0 * w exactly like the padded
// reference, so the result equals the plain PyTorch version bit for bit in
// f32 and after the final rounding to bf16.
//
// Bound on the H100: bytes.  At ASPP's (180, 240, 2048) bf16 it must read
// 177 MB and write 177 MB per branch (~106 us at 3.35 TB/s) while doing
// 18 flops per output element (~24 us at the 67 TFLOP/s f32 rate).  Design:
// channels sit on threads, each thread owning 16 bytes of channels (8 bf16 or
// 4 f32), so every tap load and the store are coalesced 16-byte accesses.
// The nine taps of neighbouring output pixels re-read the input through L1
// and L2 rather than through a shared-memory halo: the halo of a dilation-36
// tap is 72 rows, far larger than a block's share of shared memory, while the
// re-read distance (2 * d rows, <= 71 MB at d = 36) mostly stays within the
// 50 MB L2 for d = 12 and 24.  No TPU-only constraint is kept (C % 128,
// w_out rounded to 8, VMEM budgets); any C works, with a scalar kernel when
// C is not a multiple of the vector width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// V = channels per thread: Vec<T>::N for the 16-byte path, 1 for the scalar one
template <typename T, int V>
__global__ void depthwise_kernel(const T* __restrict__ x,
                                 const float* __restrict__ w,  // (9, C) f32
                                 T* __restrict__ y, int H, int W, int C, int d) {
  const int cv = C / V;
  const int64_t total = static_cast<int64_t>(H) * W * cv;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(q % cv) * V;
    const int64_t pix = q / cv;
    const int col = static_cast<int>(pix % W);
    const int row = static_cast<int>(pix / W);
    float acc[V];
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
      const int r = row + (ti - 1) * d;
      const bool row_in = r >= 0 && r < H;
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        const int cc = col + (tj - 1) * d;
        float xv[V];
        if (row_in && cc >= 0 && cc < W) {
          const T* src = x + (static_cast<int64_t>(r) * W + cc) * C + c;
          if constexpr (V == 1) {
            xv[0] = Vec<T>::to_float(src[0]);
          } else {
            Vec<T>::load(src, xv);
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xv[v] = 0.0f;
        }
        const float* wt = w + (ti * 3 + tj) * C + c;
        float wv[V];
        if constexpr (V == 1) {
          wv[0] = wt[0];
        } else {
#pragma unroll
          for (int v = 0; v < V; v += 4) Vec<float>::load(wt + v, wv + v);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float term = __fmul_rn(xv[v], wv[v]);
          acc[v] = (ti == 0 && tj == 0) ? term : __fadd_rn(acc[v], term);
        }
      }
    }
    T* dst = y + pix * C + c;
    if constexpr (V == 1) {
      dst[0] = Vec<T>::from_float(acc[0]);
    } else {
      Vec<T>::store(dst, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int H, int W, int C,
                   int d, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const bool vec = (C % N == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int64_t total = static_cast<int64_t>(H) * W * (vec ? C / N : C);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  const T* xs = static_cast<const T*>(x);
  const float* ws = static_cast<const float*>(w);
  T* ys = static_cast<T*>(y);
  if (vec) {
    depthwise_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, d);
  } else {
    depthwise_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, d);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int depthwise3x3_dilated(const void* x, const void* w, void* y, int H,
                                    int W, int C, int d, int dtype, void* stream) {
  if (H < 1 || W < 1 || C < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, y, H, W, C, d, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, w, y, H, W, C, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
