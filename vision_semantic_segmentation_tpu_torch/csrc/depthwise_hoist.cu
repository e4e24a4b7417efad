// Dilated depthwise 3x3 convolution with the taps summed column-major, for
// Hopper (sm_90a): stride 1, zero pad = dilation, NHWC, f32 accumulation,
// output in the input dtype.
//
// Replaces the probe kernels of scripts/probe_depthwise_hoist.py: hoisted
// (body _hoisted_kernel) and hoisted_variant (bodies _hoisted_f32col_kernel
// and _slab_f32_kernel).  All three compute one function: depthwise.cu's, with
// the nine terms added in column-major order (tj outer, ti inner).  Each
// term x * w is rounded in f32, the first one starts the sum and each later
// one is added with a rounded f32 add (explicit intrinsics, no FMA
// contraction), so both kernels here equal the plain PyTorch version bit for
// bit.  The TPU variants differed only in where the input was converted to
// f32 in VMEM; on the card that choice becomes two designs:
//
// * hoist_register_kernel (hoisted, hoisted_variant "f32col"): depthwise.cu's
//   layout, one output pixel and 16 bytes of channels per thread, taps read
//   through L1/L2 and converted in registers.
// * hoist_slab_kernel (hoisted_variant "slab"): a block stages an f32 copy of
//   its input tile, with the 2 * d halo, in shared memory, then every thread
//   takes its nine taps from there.  The halo decides the tile: at d = 36 a
//   16 x 16 output tile with 8 f32 channels needs 88 * 88 * 32 B = 248 KB,
//   above the 227 KB a block may have.  So the tile holds 4 channels (16 B of
//   f32 per pixel) and its side is chosen at launch: 32 x 32 outputs when
//   (32 + 2d)^2 * 16 B fits in 200 KiB (d <= 40: 169 KiB at d = 36), smaller
//   for larger dilations, down to 1 (d <= 56; larger ones are refused).  The input is read from
//   device memory into shared memory with a (32 + 2d)^2 / 32^2 halo overhead
//   (10.6x at d = 36), so this design pays in L2 traffic what it saves in
//   converts; it is the measurement for a shared-memory redesign of K3.
//
// Bound on the H100: bytes, as depthwise.cu (read x once, write y once):
// at (180, 240, 2048) bf16, 354 MB, 105.7 us at 3.35 TB/s.

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlabBytes = 200 * 1024;
constexpr int kSlabTile = 32;

template <typename T, int V>
__global__ void hoist_register_kernel(const T* __restrict__ x,
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
    for (int tj = 0; tj < 3; ++tj) {
#pragma unroll
      for (int ti = 0; ti < 3; ++ti) {
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

// CT channels of one pixel as f32 (CT = 4: one 8-byte bf16 or 16-byte f32 load)
template <typename T, int CT>
__device__ __forceinline__ void load_channels(const T* __restrict__ src, float* v) {
  if constexpr (CT == 1) {
    v[0] = Vec<T>::to_float(src[0]);
  } else if constexpr (sizeof(T) == 4) {
    Vec<float>::load(reinterpret_cast<const float*>(src), v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

template <typename T, int CT>
__device__ __forceinline__ void store_channels(T* __restrict__ dst, const float* v) {
  if constexpr (CT == 1) {
    dst[0] = Vec<T>::from_float(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    Vec<float>::store(reinterpret_cast<float*>(dst), v);
  } else {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
}

// One block: CT channels (blockIdx.x) of one tile x tile output square
// (blockIdx.y, row-major over the tiles).  Shared memory holds the
// (tile + 2d)^2 x CT f32 input slab, zeros outside the image.
template <typename T, int CT>
__global__ void hoist_slab_kernel(const T* __restrict__ x,
                                  const float* __restrict__ w,  // (9, C) f32
                                  T* __restrict__ y, int H, int W, int C, int d, int tile) {
  extern __shared__ float slab[];
  const int side = tile + 2 * d;
  const int tiles_x = (W + tile - 1) / tile;
  const int r0 = (blockIdx.y / tiles_x) * tile;
  const int c0 = (blockIdx.y % tiles_x) * tile;
  const int c = blockIdx.x * CT;

  for (int p = threadIdx.x; p < side * side; p += blockDim.x) {
    const int r = r0 - d + p / side;
    const int cc = c0 - d + p % side;
    float v[CT];
    if (r >= 0 && r < H && cc >= 0 && cc < W) {
      load_channels<T, CT>(x + (static_cast<int64_t>(r) * W + cc) * C + c, v);
    } else {
#pragma unroll
      for (int k = 0; k < CT; ++k) v[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) slab[p * CT + k] = v[k];
  }
  float wv[9][CT];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int k = 0; k < CT; ++k) wv[t][k] = w[t * C + c + k];
  }
  __syncthreads();

  for (int p = threadIdx.x; p < tile * tile; p += blockDim.x) {
    const int orow = p / tile;
    const int ocol = p % tile;
    if (r0 + orow >= H || c0 + ocol >= W) continue;
    float acc[CT];
#pragma unroll
    for (int tj = 0; tj < 3; ++tj) {
#pragma unroll
      for (int ti = 0; ti < 3; ++ti) {
        const float* s = slab + ((orow + ti * d) * side + ocol + tj * d) * CT;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const float term = __fmul_rn(s[k], wv[ti * 3 + tj][k]);
          acc[k] = (ti == 0 && tj == 0) ? term : __fadd_rn(acc[k], term);
        }
      }
    }
    store_channels<T, CT>(y + (static_cast<int64_t>(r0 + orow) * W + c0 + ocol) * C + c, acc);
  }
}

template <typename T>
cudaError_t launch_register(const void* x, const void* w, void* y, int H, int W, int C,
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
    hoist_register_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, d);
  } else {
    hoist_register_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xs, ws, ys, H, W, C, d);
  }
  return cudaGetLastError();
}

template <typename T, int CT>
cudaError_t launch_slab_ct(const T* x, const float* w, T* y, int H, int W, int C, int d,
                           cudaStream_t stream) {
  const int bytes_per_pixel = CT * static_cast<int>(sizeof(float));
  int tile = kSlabTile;
  while (tile > 0 && (tile + 2 * d) * (tile + 2 * d) * bytes_per_pixel > kSlabBytes) --tile;
  if (tile < 1) return cudaErrorInvalidValue;  // the halo alone exceeds the budget
  const int bytes = (tile + 2 * d) * (tile + 2 * d) * bytes_per_pixel;
  cudaError_t err = cudaFuncSetAttribute(hoist_slab_kernel<T, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>((H + tile - 1) / tile) * ((W + tile - 1) / tile);
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(C / CT), static_cast<unsigned>(tiles));
  hoist_slab_kernel<T, CT><<<grid, kThreads, bytes, stream>>>(x, w, y, H, W, C, d, tile);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_slab(const void* x, const void* w, void* y, int H, int W, int C, int d,
                        cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  const float* ws = static_cast<const float*>(w);
  T* ys = static_cast<T*>(y);
  const int align = 4 * static_cast<int>(sizeof(T));
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0;
  if (vec) return launch_slab_ct<T, 4>(xs, ws, ys, H, W, C, d, stream);
  return launch_slab_ct<T, 1>(xs, ws, ys, H, W, C, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int depthwise_hoist_register(const void* x, const void* w, void* y, int H, int W,
                                        int C, int d, int dtype, void* stream) {
  if (H < 1 || W < 1 || C < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_register<float>(x, w, y, H, W, C, d, s));
  if (dtype == 1) {
    return static_cast<int>(launch_register<__nv_bfloat16>(x, w, y, H, W, C, d, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int depthwise_hoist_slab(const void* x, const void* w, void* y, int H, int W,
                                    int C, int d, int dtype, void* stream) {
  if (H < 1 || W < 1 || C < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_slab<float>(x, w, y, H, W, C, d, s));
  if (dtype == 1) return static_cast<int>(launch_slab<__nv_bfloat16>(x, w, y, H, W, C, d, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
