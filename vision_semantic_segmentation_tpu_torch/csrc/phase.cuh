// Phase-staged walkers: the dilated depthwise 3x3 (stride 1, zero pad =
// dilation, NHWC, f32 sums) of depthwise.cu and depthwise_hoist.cu, for
// Hopper (sm_90a).
//
// Every tap of a 3x3 at dilation d lands on the output pixel's lattice with
// step d, so each of the d * d phases x[pr::d, pc::d] is closed under the
// taps: in phase pixels the nine taps are the dense 3x3 neighbourhood,
// whatever d is.  (aspp_depthwise.cu is the same design for several
// dilations at once, with g = their gcd; this is its case n = 1, g = d.)
// * One block per (phase, phase sub-tile, channel group), the channel group
//   fastest.  The block stages its tile with a border of one phase pixel
//   (zeros off the phase image, the neighbour tile's pixels inside it), then
//   takes every tap from shared memory at a fixed offset with no bounds
//   test.  So each input byte leaves HBM once (a sub-tiled phase re-reads
//   its one-pixel halo), and no tap goes to L2.
// * Staging: 16-byte copies (8 bf16 or 4 f32 channels of a pixel); one
//   channel at a time on the scalar path (C not a multiple of the copy, or
//   unaligned pointers).  The staged type S is the input's type T, converted
//   in registers as a walker loads, or float, converted once while staging
//   (then a tap is a plain f32 load at twice the shared bytes).  A tile in
//   the input's type is copied with cp.async; a converted one goes through
//   registers, eight copies of a thread in flight at a time.
// * Walkers: a thread keeps 4 channels (1 on the scalar path), takes their
//   9 x 4 weights from device memory into registers while the tile's copies
//   land, and walks along one line of the tile.  Each step loads the three
//   taps across the line once and feeds three running sums (the outputs one
//   step behind, at and ahead of it), so a pixel costs 3 shared loads, not 9.  Walking down a column (kDown) gives each output
//   its terms in row-major tap order (ti, then tj): depthwise.cu.  Walking
//   along a row gives column-major order (tj, then ti): depthwise_hoist.cu.
//   Each term x * w is rounded in f32, the first starts the sum and each
//   later one is added with a rounded f32 add (explicit intrinsics, no FMA
//   contraction), so the result equals the plain PyTorch version bit for
//   bit.  The first and last steps of a walk are separate instantiations, so
//   no multiply is issued for an output that does not exist.
// * Neighbouring threads hold neighbouring channels of a pixel, then
//   neighbouring lines.  A staged row is `pitch` elements long: the launch
//   plan pads it so that, where one pixel's channel group is narrower than
//   128 bytes, consecutive rows start 128-byte-disjoint and the walkers of
//   neighbouring rows hit different banks.
// * Small phases (large dilations) take wide channel groups: a block's tile
//   is sized in bytes, so that the few blocks of an SM keep enough copies in
//   flight while each waits for its own tile.  At ASPP's (180, 240, 2048)
//   bf16 the kernels with a bf16 tile run at about 0.15 ms a dilation, 70 %
//   of the byte bound, the f32 tile at 0.19 ms (chip_smoke.py, NVIDIA H100
//   80GB HBM3, 700.00 W; PERF.md, section 6).
// * The launch plan (tile, pitch, channel group, threads, shared bytes) is
//   computed in Python (ops/kernels/depthwise.py::depthwise_plan) and passed
//   in; launch() checks it against the shapes.
#pragma once

#include <type_traits>

#include "vec.cuh"

namespace phase {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on the H100

struct Plan {
  int tile_h, tile_w;  // output sub-tile of a phase, in phase pixels
  int pitch;           // staged elements per tile row, >= (tile_w + 2) * group
  int group;           // channels per block (whole 16-byte copies on the vector path)
  int threads;         // a multiple of the walker slots per pixel, group / 4 or group
  int smem;            // dynamic shared bytes: the staged tile
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a bf16 is the upper half of the f32 with the same value
__device__ __forceinline__ float bf16_lo(unsigned pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(unsigned pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// V staged channels of one pixel as loaded from shared memory (raw), and as
// f32: V = 4 (8 bytes of bf16, 16 of f32) or 1 (the scalar path).
template <typename S, int V>
struct Staged;

template <>
struct Staged<__nv_bfloat16, 4> {
  using raw = uint2;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    v[0] = bf16_lo(r.x);
    v[1] = bf16_hi(r.x);
    v[2] = bf16_lo(r.y);
    v[3] = bf16_hi(r.y);
  }
};

template <>
struct Staged<float, 4> {
  using raw = float4;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

template <typename S>
struct Staged<S, 1> {
  using raw = S;
  __device__ __forceinline__ static raw load(const S* p) { return *p; }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    v[0] = Vec<S>::to_float(r);
  }
};

// V f32 sums rounded to T and stored as one access
template <typename T, int V>
__device__ __forceinline__ void store_out(T* p, const float* v) {
  if constexpr (V == 1) {
    *p = Vec<T>::from_float(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(p),
                 "r"(*reinterpret_cast<const unsigned*>(&a)),
                 "r"(*reinterpret_cast<const unsigned*>(&b)));
  }
}

// kChunk channels of one pixel on their way through registers into a tile
// of another type, or on the scalar path: read from device memory (zeros off
// the phase image), then written to the tile as S.
template <typename T, int kChunk>
struct Chunk {
  static_assert(kChunk == 1, "the 16-byte chunks are specialisations");
  using raw = T;
  __device__ __forceinline__ static raw load(const T* src, bool inside) {
    return inside ? *src : Vec<T>::from_float(0.0f);
  }
  template <typename S>
  __device__ __forceinline__ static void put(S* dst, const raw& r) {
    if constexpr (std::is_same<S, T>::value) {
      *dst = r;
    } else {
      *dst = Vec<T>::to_float(r);
    }
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  using raw = uint4;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* src, bool inside) {
    return inside ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static void put(float* dst, const raw& r) {
    float4* out = reinterpret_cast<float4*>(dst);
    out[0] = make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y));
    out[1] = make_float4(bf16_lo(r.z), bf16_hi(r.z), bf16_lo(r.w), bf16_hi(r.w));
  }
};

// T: the input's and output's type; S: the staged type (T or float); V:
// channels per walker; kDown: walk down columns (row-major sums) or along
// rows (column-major sums).
template <typename T, typename S, int V, bool kDown>
__global__ void __launch_bounds__(kMaxThreads)
    phase_walk_kernel(const T* __restrict__ x,
                      const float* __restrict__ w,  // (9, C) f32, tap ti * 3 + tj
                      T* __restrict__ y, int H, int W, int C, int d, Plan p) {
  using St = Staged<S, V>;
  using RawT = typename St::raw;
  constexpr int kChunk = V == 1 ? 1 : 16 / sizeof(T);  // channels per staging copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* tile = reinterpret_cast<S*>(smem_raw);
  const int groups = (C + p.group - 1) / p.group;
  const int phases_c = min(d, W);
  const int tiles_r = ((H + d - 1) / d + p.tile_h - 1) / p.tile_h;
  const int tiles_c = ((W + d - 1) / d + p.tile_w - 1) / p.tile_w;
  int bid = blockIdx.x;
  const int grp = bid % groups;
  bid /= groups;
  const int tc = bid % tiles_c;
  bid /= tiles_c;
  const int tr = bid % tiles_r;
  bid /= tiles_r;
  const int pc = bid % phases_c;
  const int pr = bid / phases_c;
  const int hp = (H - pr + d - 1) / d;  // this phase's rows and columns
  const int wp = (W - pc + d - 1) / d;
  const int r0 = tr * p.tile_h;  // output sub-tile, phase coordinates
  const int c0 = tc * p.tile_w;
  if (r0 >= hp || c0 >= wp) return;  // a smaller (ragged) phase
  const int orows = min(p.tile_h, hp - r0);
  const int ocols = min(p.tile_w, wp - c0);
  // the staged tile: staged (a, b) is phase pixel (r0 - 1 + a, c0 - 1 + b)
  const int srows = orows + 2, scols = ocols + 2;
  const int ch0 = grp * p.group;
  const int vpp = p.group / V;               // walker slots per staged pixel
  const int cvalid = min(p.group, C - ch0);  // channels of this group
  const int cpp = p.group / kChunk;          // staging chunks per pixel

  {  // staging: a fixed chunk of channels per thread, pixels by increments
    const int k = threadIdx.x % cpp;  // blockDim.x is a multiple of cpp
    const int step = blockDim.x / cpp;
    const int step_a = step / scols, step_b = step % scols;
    int a = threadIdx.x / cpp / scols, b = threadIdx.x / cpp % scols;
    const int pixels = k * kChunk < cvalid ? srows * scols : 0;  // a partial group's chunks
    // the device address and the tile slot of staged pixel (a, b), then on to the next
    auto next = [&](const T*& src, S*& dst, bool& inside) {
      const int row = r0 - 1 + a, col = c0 - 1 + b;
      inside = row >= 0 && row < hp && col >= 0 && col < wp;
      src = x + (static_cast<int64_t>(pr + d * row) * W + pc + d * col) * C + ch0 + k * kChunk;
      dst = tile + a * p.pitch + b * p.group + k * kChunk;
      a += step_a;
      b += step_b;
      if (b >= scols) {
        b -= scols;
        ++a;
      }
    };
    if constexpr (std::is_same<S, T>::value && kChunk * sizeof(T) == 16) {
      for (int pix = threadIdx.x / cpp; pix < pixels; pix += step) {
        const T* src;
        S* dst;
        bool inside;
        next(src, dst, inside);
        if (inside) {
          cp_async16(dst, src);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      using Ch = Chunk<T, kChunk>;
      constexpr int kInFlight = 8;
      for (int pix = threadIdx.x / cpp; pix < pixels; pix += kInFlight * step) {
        typename Ch::raw raw[kInFlight];
        int slot[kInFlight];  // the tile element each copy goes to, -1 past the tile
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const T* src;
          S* dst;
          bool inside;
          next(src, dst, inside);
          slot[j] = pix + j * step < pixels ? static_cast<int>(dst - tile) : -1;
          raw[j] = Ch::load(src, inside && slot[j] >= 0);
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          if (slot[j] >= 0) Ch::put(tile + slot[j], raw[j]);
        }
      }
    }
  }

  // this thread's weights, on their way while the tile's copies land
  const int v = threadIdx.x % vpp;  // walker slot; blockDim.x is a multiple of vpp
  const bool walks = v < cvalid / V;
  float wv[3][3][V];  // [tap along the line][tap across it]
  if (walks) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        load_weights<V>(w + static_cast<int64_t>(kDown ? a * 3 + m : m * 3 + a) * C + ch0 + v * V,
                        wv[a][m]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Walkers: one per (line, channel slot); a line is an output column
  // (kDown) or an output row.  Along its line a walker visits the staged
  // pixels 0 .. n + 1 (n outputs).  At each it loads the three taps across
  // the line once and adds them to the three outputs that use them: staged
  // pixel t holds tap 0 (along the line) of output t, tap 1 of output t - 1
  // and tap 2 of output t - 2, which is then complete and stored.  Each
  // output thus gets its terms along-the-line tap by tap, the three across
  // in order inside each, its first term starting the sum.
  if (!walks) return;  // no barrier follows
  const int lines = kDown ? ocols : orows;
  const int n = kDown ? orows : ocols;
  const int walk = kDown ? p.pitch : p.group;    // staged elements per step along the line
  const int across = kDown ? p.group : p.pitch;  // and per tap across it
  const int64_t pixel_col = static_cast<int64_t>(d) * C, pixel_row = pixel_col * W;
  const int64_t out_walk = kDown ? pixel_row : pixel_col;
  const int64_t out_line = kDown ? pixel_col : pixel_row;
  const int64_t origin =  // output (r0, c0) of this phase, this slot's channels
      (static_cast<int64_t>(pr + d * r0) * W + pc + d * c0) * C + ch0 + v * V;
  for (int item = threadIdx.x / vpp; item < lines; item += blockDim.x / vpp) {
    const S* at = tile + item * across + v * V;                // staged pixel 0 of the line
    int64_t out_at = origin + item * out_line - 2 * out_walk;  // output t - 2 at step t
    float acc_p[V], acc_c[V], acc_n[V];  // outputs t - 2, t - 1, t
    // one staged pixel: add its taps to the outputs that exist, store output t - 2
    auto step = [&](auto has_p, auto has_c, auto has_n) {
      constexpr bool kP = decltype(has_p)::value, kC = decltype(has_c)::value;
      constexpr bool kN = decltype(has_n)::value;
      RawT raw[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) raw[m] = St::load(at + m * across);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        float xv[V];
        St::to_float(raw[m], xv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if constexpr (kN) {
            const float term = __fmul_rn(xv[k], wv[0][m][k]);
            acc_n[k] = m == 0 ? term : __fadd_rn(acc_n[k], term);
          }
          if constexpr (kC) acc_c[k] = __fadd_rn(acc_c[k], __fmul_rn(xv[k], wv[1][m][k]));
          if constexpr (kP) acc_p[k] = __fadd_rn(acc_p[k], __fmul_rn(xv[k], wv[2][m][k]));
        }
      }
      if constexpr (kP) store_out<T, V>(y + out_at, acc_p);
      at += walk;
      out_at += out_walk;
#pragma unroll
      for (int k = 0; k < V; ++k) {  // renamed away where the loop below unrolls
        acc_p[k] = acc_c[k];
        acc_c[k] = acc_n[k];
      }
    };
    using yes = std::true_type;
    using no = std::false_type;
    step(no{}, no{}, yes{});
    if (n >= 2) {
      step(no{}, yes{}, yes{});
    } else {
      step(no{}, yes{}, no{});
    }
#pragma unroll 3
    for (int t = 2; t < n; ++t) step(yes{}, yes{}, yes{});
    if (n >= 2) step(yes{}, yes{}, no{});
    step(yes{}, no{}, no{});
  }
}

// Checks the plan against the shapes and launches.  vector: 16-byte staging
// and 4 channels per walker (C must fill whole copies, x, w and y be 16-byte
// aligned), else one channel at a time.
template <typename T, typename S, bool kDown>
cudaError_t launch(const void* x, const void* w, void* y, int H, int W, int C, int d,
                   const Plan& p, int vector, cudaStream_t stream) {
  if (p.tile_h < 1 || p.tile_w < 1 || p.group < 1 || p.threads < 1) return cudaErrorInvalidValue;
  constexpr int N = Vec<T>::N;  // channels per 16-byte staging copy
  if (vector) {
    const void* ptrs[] = {x, y, w};
    if (!vector_ok(C, N, ptrs, 3) || p.group % N != 0) return cudaErrorInvalidValue;
    if (p.pitch * sizeof(S) % 16 != 0) return cudaErrorInvalidValue;
  }
  const int V = vector ? 4 : 1;  // channels per walker
  if (p.threads % (p.group / V) != 0 || p.threads > kMaxThreads) return cudaErrorInvalidValue;
  if (p.pitch < static_cast<int64_t>(p.tile_w + 2) * p.group) return cudaErrorInvalidValue;
  const int64_t staged = static_cast<int64_t>(p.tile_h + 2) * p.pitch * sizeof(S);
  if (staged > p.smem || p.smem > kMaxSmem) return cudaErrorInvalidValue;
  const int hp = (H + d - 1) / d, wp = (W + d - 1) / d;
  const int64_t blocks = static_cast<int64_t>(d < H ? d : H) * (d < W ? d : W) *
                         ((hp + p.tile_h - 1) / p.tile_h) * ((wp + p.tile_w - 1) / p.tile_w) *
                         ((C + p.group - 1) / p.group);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = vector ? &phase_walk_kernel<T, S, 4, kDown> : &phase_walk_kernel<T, S, 1, kDown>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), H, W, C, d, p);
  return cudaGetLastError();
}

// The C entry points' body.  dtype: 0 = float32, 1 = bfloat16; plan: tile_h,
// tile_w, pitch, group, threads, smem bytes, vector, as depthwise_plan gives
// it.  kF32Tile stages a bf16 input as f32 (an f32 input is f32 either way).
template <bool kDown, bool kF32Tile>
int run(const void* x, const void* w, void* y, int H, int W, int C, int d, int dtype,
        const int* plan, void* stream) {
  if (H < 1 || W < 1 || C < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  using Tile = std::conditional_t<kF32Tile, float, bf16>;
  if (dtype == 0) {
    return static_cast<int>(launch<float, float, kDown>(x, w, y, H, W, C, d, p, plan[6], s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<bf16, Tile, kDown>(x, w, y, H, W, C, d, p, plan[6], s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace phase
