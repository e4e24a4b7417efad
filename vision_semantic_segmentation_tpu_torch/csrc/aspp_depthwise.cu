// ASPP's atrous depthwise branches in one pass for Hopper (sm_90a): for each
// of n dilations, a depthwise 3x3 convolution with stride 1 and zero pad =
// dilation over the same NHWC input, f32 accumulation, outputs in the input
// dtype stacked as (n, H, W, C).
//
// Replaces the TPU kernel vision_semantic_segmentation_tpu/ops/pallas/
// depthwise.py :: aspp_depthwise3x3_multi (body _fused_kernel).  Each branch
// is depthwise.cu's kernel bit for bit: the same taps in row-major order (ti,
// then tj), each term x * w rounded in f32, the first term starting the sum,
// each later one added with a rounded f32 add (explicit intrinsics, no FMA
// contraction), out-of-image taps contributing 0 * w.
//
// Bound on the H100: bytes.  At ASPP's (180, 240, 2048) bf16 with dilations
// 12/24/36 the function must read the input once (177 MB) and write three
// outputs (531 MB): 708 MB, 0.211 ms at 3.35 TB/s, against 1062 MB for three
// single-branch launches.  Nothing is padded in device memory: the TPU kernel
// padded every branch to the largest dilation, and its v5e measurement blamed
// that padding for its loss.
//
// Design (times: bf16 at that shape, chip_smoke.py, H100 80GB HBM3, 700 W):
// * depthwise.cu's thread layout: one output pixel and 16 bytes of channels
//   (8 bf16) per thread, neighbouring threads on neighbouring channels, so
//   each tap load and each store of a warp is 512 contiguous bytes.  A loop
//   over the branches runs inside the thread.  The centre tap (1, 1) is the
//   same pixel for every dilation and is loaded once.  Each branch's result
//   is stored before the next branch starts, so one set of f32 accumulators
//   is live at a time.
// * The walk is channel-group-major: a warp covers kLanes vectors (256 bf16
//   channels) of a pixel, consecutive warps consecutive pixels, and the next
//   channel group starts only after the whole image; the launch has one
//   thread per item, so blocks run in that order.  The taps of all branches
//   reach +-max(d) rows: with every channel of a pixel in flight
//   (depthwise.cu's order) rows are re-read 2 * 36 * 240 * 4 KB = 71 MB
//   apart, beyond the 50 MB L2, and that order took 1.27 ms; per channel
//   group the distance is 8.8 MB, and this order takes 1.02 ms.
// * Against three K3 launches (0.885 ms) it is slower.  No block shares a
//   tap with another pixel's, so all ~25 tap loads per pixel come from L2,
//   and the kernel runs at the L2's rate, not HBM's, like K3 itself (K3 runs
//   faster at d = 36, where more taps fall outside the image).  Holding each
//   branch's weights in registers over 8 pixels per thread, which removes
//   two thirds of the L1 loads, measured 1.07 ms.  Going faster needs taps
//   reused inside a block, e.g. walking each column in steps of d so that
//   every input row is loaded once for three outputs: a redesign, not this
//   port.

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBranches = 8;
constexpr int kLanes = 32;  // vectors of one pixel per channel group

struct Dilations {
  int d[kMaxBranches];
};

template <typename T, int V>
__global__ void aspp_depthwise_kernel(const T* __restrict__ x,
                                      const float* __restrict__ w,  // (n, 9, C) f32
                                      T* __restrict__ y,            // (n, H, W, C)
                                      int H, int W, int C, int n, Dilations dil) {
  const int cv = C / V;
  const int lanes = cv < kLanes ? cv : kLanes;
  const int64_t pixels = static_cast<int64_t>(H) * W;
  const int64_t plane = pixels * C;
  const int64_t total = (cv + lanes - 1) / lanes * pixels * lanes;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int lane = static_cast<int>(q % lanes);
    const int64_t rest = q / lanes;
    const int64_t pix = rest % pixels;
    const int vec = static_cast<int>(rest / pixels) * lanes + lane;
    if (vec >= cv) continue;  // the ragged last channel group
    const int c = vec * V;
    const int col = static_cast<int>(pix % W);
    const int row = static_cast<int>(pix / W);
    float centre[V];
    load_pixel<T, V>(x, H, W, C, row, col, c, centre);
#pragma unroll
    for (int b = 0; b < kMaxBranches; ++b) {
      if (b >= n) break;
      const int d = dil.d[b];
      const float* wb = w + static_cast<int64_t>(b) * 9 * C + c;
      float acc[V];
#pragma unroll
      for (int ti = 0; ti < 3; ++ti) {
#pragma unroll
        for (int tj = 0; tj < 3; ++tj) {
          float xv[V], wv[V];
          if (ti == 1 && tj == 1) {
#pragma unroll
            for (int v = 0; v < V; ++v) xv[v] = centre[v];
          } else {
            load_pixel<T, V>(x, H, W, C, row + (ti - 1) * d, col + (tj - 1) * d, c, xv);
          }
          load_weights<V>(wb + (ti * 3 + tj) * C, wv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float term = __fmul_rn(xv[v], wv[v]);
            acc[v] = (ti == 0 && tj == 0) ? term : __fadd_rn(acc[v], term);
          }
        }
      }
      store_pixel<T, V>(y + b * plane + pix * C + c, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int H, int W, int C, int n,
                   Dilations dil, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const void* ptrs[] = {x, y, w};
  const bool vec = vector_ok(C, N, ptrs, 3);
  const int cv = vec ? C / N : C;
  const int lanes = cv < kLanes ? cv : kLanes;
  const int64_t total = (cv + lanes - 1) / lanes * static_cast<int64_t>(H) * W * lanes;
  // one thread per item, no grid-stride cap: blocks are issued in index
  // order, so the walk through the image is monotonic in time
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  if (blocks < 1) blocks = 1;
  const T* xs = static_cast<const T*>(x);
  const float* ws = static_cast<const float*>(w);
  T* ys = static_cast<T*>(y);
  if (vec) {
    aspp_depthwise_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, n, dil);
  } else {
    aspp_depthwise_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, n, dil);
  }
  return cudaGetLastError();
}

}  // namespace

// dilations: n values (1 <= n <= 8) in an array of 8; dtype: 0 = float32,
// 1 = bfloat16
extern "C" int aspp_depthwise3x3_multi(const void* x, const void* w, void* y, int H, int W,
                                       int C, int n, const int* dilations, int dtype,
                                       void* stream) {
  if (H < 1 || W < 1 || C < 1 || n < 1 || n > kMaxBranches) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dilations dil{};
  for (int b = 0; b < n; ++b) {
    if (dilations[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
    dil.d[b] = dilations[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, y, H, W, C, n, dil, s));
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(x, w, y, H, W, C, n, dil, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
