// Evidence fold for Hopper (sm_90a): grid += E @ obs, in place.
//
// Replaces the TPU kernel vision_semantic_segmentation_tpu/ops/pallas/fold.py
// :: evidence_fold_add (body _kernel).  grid and obs are planar (C, H, W) f32;
// E is (C, C).  Per cell, in that kernel's order:
//     acc[c] = grid[c];  for i = 0..C-1: acc[c] = acc[c] + E[c, i] * obs[i]
// with every multiply and add an explicitly rounded intrinsic (no FMA
// contraction), so the result equals the plain PyTorch version exactly.
//
// Bound on the H100: bytes.  Each cell reads C grid and C obs values and
// writes C grid values (3 * C * 4 bytes); the C*C multiply-adds are far below
// the f32 rate.  Design: E travels by value in the kernel's parameter space
// (constant bank, no load per thread); each thread owns four consecutive
// cells and moves them as float4, so every load and store is a 16-byte
// coalesced access; C is a template parameter so the accumulators stay in
// registers.  A scalar kernel covers a cell count that is not a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;

struct Evidence {
  float e[kMaxC * kMaxC];
};

template <int C>
__global__ void fold_vec4_kernel(float4* __restrict__ grid,
                                 const float4* __restrict__ obs, Evidence E,
                                 int64_t n4) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < n4; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 o[C];
#pragma unroll
    for (int i = 0; i < C; ++i) o[i] = obs[i * n4 + q];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float4 acc = grid[c * n4 + q];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float e = E.e[c * C + i];
        acc.x = __fadd_rn(acc.x, __fmul_rn(e, o[i].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(e, o[i].y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(e, o[i].z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(e, o[i].w));
      }
      grid[c * n4 + q] = acc;
    }
  }
}

template <int C>
__global__ void fold_scalar_kernel(float* __restrict__ grid,
                                   const float* __restrict__ obs, Evidence E,
                                   int64_t n) {
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < n; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float o[C];
#pragma unroll
    for (int i = 0; i < C; ++i) o[i] = obs[i * n + p];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = grid[c * n + p];
#pragma unroll
      for (int i = 0; i < C; ++i)
        acc = __fadd_rn(acc, __fmul_rn(E.e[c * C + i], o[i]));
      grid[c * n + p] = acc;
    }
  }
}

template <int C>
cudaError_t launch(float* grid, const float* obs, const Evidence& E, int64_t n,
                   cudaStream_t stream) {
  const bool vec = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(grid) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(obs) % 16 == 0);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  if (blocks < 1) blocks = 1;
  if (vec) {
    fold_vec4_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(grid), reinterpret_cast<const float4*>(obs), E,
        n / 4);
  } else {
    fold_scalar_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        grid, obs, E, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int evidence_fold_add(void* grid, const void* obs, const void* evidence,
                                 int C, long long n, void* stream) {
  if (C < 1 || C > kMaxC || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Evidence E{};
  const float* host_e = static_cast<const float*>(evidence);  // (C, C) host f32
  for (int i = 0; i < C * C; ++i) E.e[i] = host_e[i];
  float* g = static_cast<float*>(grid);
  const float* o = static_cast<const float*>(obs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = launch<1>(g, o, E, n, s); break;
    case 2: err = launch<2>(g, o, E, n, s); break;
    case 3: err = launch<3>(g, o, E, n, s); break;
    case 4: err = launch<4>(g, o, E, n, s); break;
    case 5: err = launch<5>(g, o, E, n, s); break;
    case 6: err = launch<6>(g, o, E, n, s); break;
    case 7: err = launch<7>(g, o, E, n, s); break;
    default: err = launch<8>(g, o, E, n, s); break;
  }
  return static_cast<int>(err);
}
