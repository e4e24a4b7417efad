// Q1: int8 3x3 convolution with the requantize epilogue, for Hopper (sm_90a).
//
// A port-only kernel: the JAX package runs its int8 convs through XLA's
// conv_general_dilated with preferred_element_type=int32
// (vision_semantic_segmentation_tpu/models/quant.py:72-78, :385-392), and no
// PyTorch call runs an int8 grouped, dilated, strided conv with int32
// accumulation on CUDA.  It carries every 3x3 site of the int8 backbone: the
// grouped conv2 of a bottleneck (ResNeXt: 32 groups of 4, 8, 16 or 32
// channels) and both 3x3s of a BasicBlock (groups 1, up to 512 channels).
//
//   x    (N, H, W, Cin) int8, channels last
//   w    (Cout, 3, 3, Cin / groups) int8
//   acc  = sum over taps and the group's input channels of x * w   (int32)
//   int8 out:  q = __float2int_rn(acc * scale[c] + shift[c]) clipped to
//              [relu ? 0 : -127, 127]      (scale = total / out_scale and
//              shift = bias / out_scale, computed on the host in f32 in the
//              JAX package's order; ReLU folds into the clip)
//   float out: v = acc * scale[c] + shift[c], max(v, 0) with relu, stored as
//              f32 or bf16 (round to nearest even)
// Each multiply and add is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn: no FMA contraction) and the int32 sum is exact, so the kernel
// equals its plain PyTorch version (an f64 conv of the int8 values, exact
// below 2^53, then the same f32 epilogue) bit for bit.
//
// Bound on the H100: at the backbone's shapes the int8 operations at 1,979
// TOPS and the bytes at 3.35 TB/s give bounds of the same order (a few tens
// of microseconds a site).  This first design is simple and right, not fast:
// __dp4a (4 int8 products into an int32 a lane) on the CUDA cores, not the
// tensor cores.  A thread owns one output pixel and CO_T output channels of
// one group; the block's 128 pixels share those channels, so each weight
// load is warp-uniform (one broadcast), and each input load (VEC words of 4
// channels, up to 16 bytes) feeds CO_T * VEC dp4a.  Consecutive blocks take
// the other channel chunks of the same pixels, so the input tile is reused
// from L1/L2.  IMMA (mma.sync s8) or wgmma is the later design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kOutInt8 = 0;
constexpr int kOutF32 = 1;
constexpr int kOutBF16 = 2;

// 1, 2 or 4 int32 words: one 4-, 8- or 16-byte access
__device__ __forceinline__ void load_words(int (&d)[1], const int* s) { d[0] = __ldg(s); }
__device__ __forceinline__ void load_words(int (&d)[2], const int* s) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(s));
  d[0] = v.x;
  d[1] = v.y;
}
__device__ __forceinline__ void load_words(int (&d)[4], const int* s) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(s));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void store_words(void* d, const uint32_t (&w)[1]) {
  *static_cast<uint32_t*>(d) = w[0];
}
__device__ __forceinline__ void store_words(void* d, const uint32_t (&w)[2]) {
  *static_cast<uint2*>(d) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void store_words(void* d, const uint32_t (&w)[4]) {
  *static_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int CO_T, int VEC>
__global__ void __launch_bounds__(kThreads)
int8_conv3x3_kernel(const int8_t* __restrict__ x, const int* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    void* __restrict__ out, int N, int H, int W, int Cin, int Ho, int Wo,
                    int Cout, int cin_g, int cout_g, int stride, int pad, int dil,
                    int out_kind, int relu) {
  const int nco = Cout / CO_T;
  const int chunk = static_cast<int>(blockIdx.x % nco);
  const long long p = static_cast<long long>(blockIdx.x / nco) * kThreads + threadIdx.x;
  const long long P = static_cast<long long>(N) * Ho * Wo;
  if (p >= P) return;
  const int co0 = chunk * CO_T;
  const int g = co0 / cout_g;
  const int wo = static_cast<int>(p % Wo);
  const long long t = p / Wo;
  const int ho = static_cast<int>(t % Ho);
  const int n = static_cast<int>(t / Ho);
  const int kw4 = cin_g / 4;  // int32 words of 4 channels a tap
  const int* wbase = w + static_cast<long long>(co0) * 9 * kw4;

  int acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0;

  for (int ky = 0; ky < 3; ++ky) {
    const int iy = ho * stride - pad + ky * dil;
    if (iy < 0 || iy >= H) continue;
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = wo * stride - pad + kx * dil;
      if (ix < 0 || ix >= W) continue;
      const int* xp = reinterpret_cast<const int*>(
          x + ((static_cast<long long>(n) * H + iy) * W + ix) * Cin +
          static_cast<long long>(g) * cin_g);
      const int* wt = wbase + (ky * 3 + kx) * kw4;
      for (int k = 0; k < kw4; k += VEC) {
        int xv[VEC];
        load_words(xv, xp + k);
#pragma unroll
        for (int j = 0; j < CO_T; ++j) {
          int wv[VEC];
          load_words(wv, wt + static_cast<long long>(j) * 9 * kw4 + k);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[j] = __dp4a(xv[v], wv[v], acc[j]);
        }
      }
    }
  }

  const long long o = p * Cout + co0;
  float y[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j)
    y[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), __ldg(scale + co0 + j)),
                     __ldg(shift + co0 + j));
  if (out_kind == kOutInt8) {
    const int lo = relu ? 0 : -127;
    uint32_t words[CO_T / 4];
#pragma unroll
    for (int j = 0; j < CO_T / 4; ++j) words[j] = 0u;
#pragma unroll
    for (int j = 0; j < CO_T; ++j) {
      const int q = min(max(__float2int_rn(y[j]), lo), 127);
      words[j / 4] |= static_cast<uint32_t>(q & 0xff) << (8 * (j % 4));
    }
    store_words(static_cast<int8_t*>(out) + o, words);
    return;
  }
  if (relu) {
#pragma unroll
    for (int j = 0; j < CO_T; ++j) y[j] = fmaxf(y[j], 0.0f);
  }
  if (out_kind == kOutF32) {
#pragma unroll
    for (int j = 0; j < CO_T; j += 4) {
      const uint32_t words[4] = {__float_as_uint(y[j]), __float_as_uint(y[j + 1]),
                                 __float_as_uint(y[j + 2]), __float_as_uint(y[j + 3])};
      store_words(static_cast<float*>(out) + o + j, words);
    }
    return;
  }
  uint32_t words[CO_T / 2];  // two bf16 a word, the lower channel in the low half
#pragma unroll
  for (int j = 0; j < CO_T; j += 2)
    words[j / 2] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y[j]))) |
                   (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y[j + 1])))
                    << 16);
  store_words(static_cast<__nv_bfloat16*>(out) + o, words);
}

template <int CO_T, int VEC>
cudaError_t launch(const int8_t* x, const int* w, const float* scale, const float* shift,
                   void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                   int cin_g, int cout_g, int stride, int pad, int dil, int out_kind,
                   int relu, cudaStream_t stream) {
  const long long P = static_cast<long long>(N) * Ho * Wo;
  const long long blocks = (P + kThreads - 1) / kThreads * (Cout / CO_T);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  int8_conv3x3_kernel<CO_T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, w, scale, shift, out, N, H, W, Cin, Ho, Wo, Cout, cin_g, cout_g, stride, pad, dil,
      out_kind, relu);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does
// not take (the wrapper checks them first).
extern "C" int int8_conv3x3(const void* x, const void* w, const void* scale, const void* shift,
                            void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                            int groups, int stride, int pad, int dil, int out_kind, int relu,
                            void* stream) {
  if (groups < 1 || Cin % groups || Cout % groups || N < 1 || Ho < 1 || Wo < 1 ||
      stride < 1 || dil < 1 || pad < 0 || out_kind < kOutInt8 || out_kind > kOutBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cin_g = Cin / groups;
  const int cout_g = Cout / groups;
  if (cin_g % 4 || cout_g % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xs = static_cast<const int8_t*>(x);
  const int* ws = static_cast<const int*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool co8 = cout_g % 8 == 0;
  const int vec = cin_g % 16 == 0 ? 4 : (cin_g % 8 == 0 ? 2 : 1);
#define Q1_LAUNCH(CO, V)                                                                  \
  launch<CO, V>(xs, ws, sc, sh, out, N, H, W, Cin, Ho, Wo, Cout, cin_g, cout_g, stride,   \
                pad, dil, out_kind, relu, s)
  cudaError_t err;
  if (co8) {
    err = vec == 4 ? Q1_LAUNCH(8, 4) : (vec == 2 ? Q1_LAUNCH(8, 2) : Q1_LAUNCH(8, 1));
  } else {
    err = vec == 4 ? Q1_LAUNCH(4, 4) : (vec == 2 ? Q1_LAUNCH(4, 2) : Q1_LAUNCH(4, 1));
  }
#undef Q1_LAUNCH
  return static_cast<int>(err);
}
