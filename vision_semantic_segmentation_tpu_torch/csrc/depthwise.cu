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

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

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
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        float xv[V], wv[V];
        load_pixel<T, V>(x, H, W, C, row + (ti - 1) * d, col + (tj - 1) * d, c, xv);
        load_weights<V>(w + (ti * 3 + tj) * C + c, wv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float term = __fmul_rn(xv[v], wv[v]);
          acc[v] = (ti == 0 && tj == 0) ? term : __fadd_rn(acc[v], term);
        }
      }
    }
    store_pixel<T, V>(y + pix * C + c, acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int H, int W, int C,
                   int d, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const void* ptrs[] = {x, y, w};
  const bool vec = vector_ok(C, N, ptrs, 3);
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
