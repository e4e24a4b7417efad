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
// contraction), out-of-image taps contributing 0 * w, one rounding to the
// input dtype at the end.
//
// Bound on the H100: bytes.  At ASPP's (180, 240, 2048) bf16 with dilations
// 12/24/36 the function must read the input once (177 MB) and write three
// outputs (531 MB): 708 MB, 0.211 ms at 3.35 TB/s.
//
// Design: phases.  Every tap of a 3x3 at dilation d lands on the output
// pixel's lattice with step d, so with g = gcd of the dilations each of the
// g * g phases x[pr::g, pc::g] is closed under every branch's taps: branch b
// reads phase neighbours at +-d_b / g.  At the main path's shape g = 12 and a
// phase is a dense 15x20 image.
// * One block per (phase, phase sub-tile, channel group), the channel group
//   fastest, so the blocks in flight together cover all channels of a few
//   phases.  The block stages its tile with a border of `halo` phase pixels
//   (zeros off the phase image), then computes every branch from shared
//   memory.  With the full halo, max(d) / g, every tap is a shared load at a
//   fixed offset, with no bounds test; a plan whose halo is cut to fit
//   shared memory takes an instantiation that reads the far taps from
//   device memory.  So each input byte leaves HBM once, and the ~25 tap
//   loads per pixel come from shared memory (a per-pixel walk takes them all
//   from L2, which the 177 MB input does not fit).
// * Staging: 16-byte cp.async copies (8 bf16 or 4 f32 channels of a pixel),
//   one channel at a time on the scalar path (C not a multiple of the copy,
//   or an input that is not 16-byte aligned).  The group's weights (n x 9 x
//   group f32) follow the tile.
// * Row walkers: a thread keeps 4 channels (1 on the scalar path) and takes,
//   branch by branch, columns of the tile, one row residue mod d / g each,
//   with the branch's 9 x 4 weights in registers.  Each row it visits is
//   loaded and converted once and feeds three running sums (the outputs one
//   step above, at and below it), so a pixel costs 3 shared loads per
//   branch, not 9; each sum still takes its taps in row-major order.  The
//   first and last rows of a walk are separate instantiations of the step,
//   so no multiply is issued for an output that does not exist.
//   Neighbouring threads hold neighbouring channels of a pixel: a half- or
//   quarter-warp reads one pixel's contiguous bytes (no bank conflicts).
// * Why 4 channels and not 16 bytes a thread: 8 bf16 channels took 160-195
//   registers (9 weights, 3 sums, taps) and left two or three warps per
//   scheduler.  With 4, a step is 97 instructions, 68 of them the
//   rounded multiplies and adds, and the kernel runs at instruction issue:
//   about 0.40 ms at the main path's shape, half of the byte bound, against
//   0.89 ms for three depthwise.cu launches (chip_smoke.py, NVIDIA H100
//   80GB HBM3, 700.00 W; PERF.md, section 6).
// * The launch plan (g, tile, halo, channel group, threads, shared bytes) is
//   computed in Python (ops/kernels/depthwise.py::aspp_plan) and passed in;
//   this entry point checks it against the shapes and launches.

#include <algorithm>
#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kMaxBranches = 8;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's limit on the H100

struct Steps {
  int s[kMaxBranches];  // d_b / g
};

struct Plan {
  int g;                // phase lattice step: gcd of the dilations
  int tile_h, tile_w;   // output sub-tile of a phase, in phase pixels
  int halo;             // staged halo around the sub-tile, in phase pixels
  int group;            // channels per block (whole 16-byte copies on the vector path)
  int threads;          // a multiple of the walker slots per pixel, group / 4 or group
  int smem;             // dynamic shared bytes
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// V channels of one pixel as read from memory (raw), and converted to and
// from f32: V = 4 (8 bytes of bf16, 16 of f32) or 1 (the scalar path).
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16, 4> {
  using raw = uint2;
  __device__ __forceinline__ static raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static raw zero() { return make_uint2(0u, 0u); }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    // a bf16 is the upper half of the f32 with the same value
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(p),
                 "r"(*reinterpret_cast<const unsigned*>(&a)),
                 "r"(*reinterpret_cast<const unsigned*>(&b)));
  }
};

template <>
struct Lanes<float, 4> {
  using raw = float4;
  __device__ __forceinline__ static raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static raw zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <typename T>
struct Lanes<T, 1> {
  using raw = T;
  __device__ __forceinline__ static raw load(const T* p) { return *p; }
  __device__ __forceinline__ static raw zero() { return Vec<T>::from_float(0.0f); }
  __device__ __forceinline__ static void to_float(const raw& r, float* v) {
    v[0] = Vec<T>::to_float(r);
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    *p = Vec<T>::from_float(v[0]);
  }
};

template <typename T, int V, bool kFullHalo>
__global__ void __launch_bounds__(kMaxThreads)
    aspp_phase_kernel(const T* __restrict__ x,
                      const float* __restrict__ w,  // (n, 9, C) f32
                      T* __restrict__ y,            // (n, H, W, C)
                      int H, int W, int C, int n, Steps st, Plan p) {
  using R = Lanes<T, V>;
  using RawT = typename R::raw;
  constexpr int kChunk = V == 1 ? 1 : 16 / sizeof(T);  // channels per staging copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int g = p.g;
  const int groups = (C + p.group - 1) / p.group;
  const int phases_c = min(g, W);
  const int tiles_r = ((H + g - 1) / g + p.tile_h - 1) / p.tile_h;
  const int tiles_c = ((W + g - 1) / g + p.tile_w - 1) / p.tile_w;
  int bid = blockIdx.x;
  const int grp = bid % groups;
  bid /= groups;
  const int tc = bid % tiles_c;
  bid /= tiles_c;
  const int tr = bid % tiles_r;
  bid /= tiles_r;
  const int pc = bid % phases_c;
  const int pr = bid / phases_c;
  const int hp = (H - pr + g - 1) / g;  // this phase's rows and columns
  const int wp = (W - pc + g - 1) / g;
  const int r0 = tr * p.tile_h;  // output sub-tile, phase coordinates
  const int c0 = tc * p.tile_w;
  if (r0 >= hp || c0 >= wp) return;  // a smaller (ragged) phase
  const int r1 = min(r0 + p.tile_h, hp);
  const int c1 = min(c0 + p.tile_w, wp);
  // the staged tile: the sub-tile and a border of `halo` phase pixels, zero
  // where it leaves the phase image, p.tile_w + 2 * halo pixels a row
  const int h = p.halo;
  const int srow0 = r0 - h, scol0 = c0 - h;
  const int srows = r1 - r0 + 2 * h, scols = c1 - c0 + 2 * h;
  const int pitch = (p.tile_w + 2 * h) * p.group;  // elements per staged row
  const int ch0 = grp * p.group;
  const int vpp = p.group / V;                  // walker slots per staged pixel
  const int cvalid = min(p.group, C - ch0);     // channels of this group
  const int valid = cvalid / V;                 // slots holding channels
  const int cpp = p.group / kChunk;             // staging chunks per pixel
  float* wsm = reinterpret_cast<float*>(
      smem_raw + (((p.tile_h + 2 * h) * pitch * sizeof(T) + 15) & ~15));

  {  // staging: a fixed chunk of channels per thread, pixels by increments
    const int k = threadIdx.x % cpp;  // blockDim.x is a multiple of cpp
    const int step = blockDim.x / cpp;
    const int step_a = step / scols, step_b = step % scols;
    int a = threadIdx.x / cpp / scols, b = threadIdx.x / cpp % scols;
    const bool staged_chunk = k * kChunk < cvalid;
    for (int pix = threadIdx.x / cpp; staged_chunk && pix < srows * scols; pix += step) {
      const int row = srow0 + a, col = scol0 + b;
      T* dst = tile + a * pitch + b * p.group + k * kChunk;
      const bool inside = row >= 0 && row < hp && col >= 0 && col < wp;
      const T* src =
          x + (static_cast<int64_t>(pr + g * row) * W + pc + g * col) * C + ch0 + k * kChunk;
      if constexpr (kChunk * sizeof(T) == 16) {
        if (inside) {
          cp_async16(dst, src);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        *dst = inside ? *src : Vec<T>::from_float(0.0f);
      }
      a += step_a;
      b += step_b;
      if (b >= scols) {
        b -= scols;
        ++a;
      }
    }
  }
  for (int i = threadIdx.x; i < n * 9 * cvalid; i += blockDim.x) {  // weights: (n, 9, group)
    const int t = i / cvalid;
    wsm[t * p.group + i - t * cvalid] = w[static_cast<int64_t>(t) * C + ch0 + i - t * cvalid];
  }
  cp_async_wait_all();
  __syncthreads();

  // Walkers: for branch b with step s, one per (row residue rho < s, output
  // column, 4-channel slot).  A walker goes down its column in steps of s
  // over rows i0 - s, i0, ..., last + s (i0 = r0 + rho).  Each row it loads
  // its three taps once and adds them to the three outputs that use that
  // row: row r is tap row 0 of output r + s, row 1 of output r and row 2 of
  // output r - s.  Each output thus gets its terms in row-major tap order,
  // its first term starting the sum, as in the plain version.  A thread
  // keeps one slot and takes the walkers of each branch in turn, so it
  // loads a branch's weights once.
  const int v = threadIdx.x % vpp;  // blockDim.x is a multiple of vpp
  if (v >= valid) return;           // no barrier follows
  const int ocols = c1 - c0;
  const int orows = r1 - r0;
  const int lanes = blockDim.x / vpp;
  const int c = ch0 + v * V;
  const T* slot = tile + v * V;
  const int64_t plane = static_cast<int64_t>(H) * W * C;
  int item = threadIdx.x / vpp;
#pragma unroll 1
  for (int b = 0; b < n; ++b) {
    int s = 1;
#pragma unroll
    for (int k = 0; k < kMaxBranches; ++k) {  // st.s[b] without a dynamic index
      if (k == b) s = st.s[k];
    }
    const int items = min(s, orows) * ocols;
    if (item >= items) {
      item -= items;
      continue;
    }
    float wv[9][V];
#pragma unroll
    for (int t = 0; t < 9; ++t) load_weights<V>(wsm + (b * 9 + t) * p.group + v * V, wv[t]);
    for (; item < items; item += lanes) {
      const int pj = c0 + item % ocols;
      const int i0 = r0 + item / ocols;
      const int last = i0 + (r1 - 1 - i0) / s * s;
      int col_at[3], col_off[3];
#pragma unroll
      for (int tj = 0; tj < 3; ++tj) {
        col_at[tj] = pj + (tj - 1) * s;
        col_off[tj] = min(max(col_at[tj] - scol0, 0), scols - 1) * p.group;
      }

      // the staged row r and the output pixel of row r - s, moved down one
      // step by each row
      const T* line = slot + (i0 - s - srow0) * pitch;
      int64_t out_at = b * plane + c +
                       (static_cast<int64_t>(pr + g * (i0 - 2 * s)) * W + pc + g * pj) * C;
      const int64_t out_step = static_cast<int64_t>(s) * g * W * C;
      // one row's three taps.  With the full halo they all lie in the staged
      // tile (zeros off the phase image); a cut halo leaves some in device
      // memory, or off the image (zero)
      auto fetch = [&](int r, RawT (&raw)[3]) {
        if constexpr (kFullHalo) {
#pragma unroll
          for (int tj = 0; tj < 3; ++tj) raw[tj] = R::load(line + col_off[tj]);
        } else {
          const bool row_staged = r >= srow0 && r < srow0 + srows;
          const bool row_in = r >= 0 && r < hp;
          const T* at = slot + min(max(r - srow0, 0), srows - 1) * pitch;
#pragma unroll
          for (int tj = 0; tj < 3; ++tj) {
            const int col = col_at[tj];
            if (row_staged && col >= scol0 && col < scol0 + scols) {
              raw[tj] = R::load(at + col_off[tj]);
            } else if (row_in && col >= 0 && col < wp) {
              raw[tj] = R::load(x + (static_cast<int64_t>(pr + g * r) * W + pc + g * col) * C + c);
            } else {
              raw[tj] = R::zero();
            }
          }
        }
      };
      float acc_p[V], acc_c[V], acc_n[V];  // outputs r - s, r, r + s
      // one row: add its taps to the outputs that exist, store output r - s
      auto step = [&](int r, auto has_p, auto has_c, auto has_n) {
        constexpr bool kP = decltype(has_p)::value, kC = decltype(has_c)::value;
        constexpr bool kN = decltype(has_n)::value;
        RawT raw[3];
        fetch(r, raw);
#pragma unroll
        for (int tj = 0; tj < 3; ++tj) {
          float xv[V];
          R::to_float(raw[tj], xv);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if constexpr (kN) {
              const float term = __fmul_rn(xv[k], wv[tj][k]);
              acc_n[k] = tj == 0 ? term : __fadd_rn(acc_n[k], term);
            }
            if constexpr (kC) acc_c[k] = __fadd_rn(acc_c[k], __fmul_rn(xv[k], wv[3 + tj][k]));
            if constexpr (kP) acc_p[k] = __fadd_rn(acc_p[k], __fmul_rn(xv[k], wv[6 + tj][k]));
          }
        }
        if constexpr (kP) R::store(y + out_at, acc_p);
        line += s * pitch;
        out_at += out_step;
#pragma unroll
        for (int k = 0; k < V; ++k) {  // renamed away where the loop below unrolls
          acc_p[k] = acc_c[k];
          acc_c[k] = acc_n[k];
        }
      };
      using yes = std::true_type;
      using no = std::false_type;
      step(i0 - s, no{}, no{}, yes{});
      if (i0 + s <= last) {
        step(i0, no{}, yes{}, yes{});
      } else {
        step(i0, no{}, yes{}, no{});
      }
#pragma unroll 3
      for (int r = i0 + s; r <= last - s; r += s) step(r, yes{}, yes{}, yes{});
      if (last >= i0 + s) step(last, yes{}, yes{}, no{});
      step(last + s, yes{}, no{}, no{});
    }
    item -= items;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int H, int W, int C, int n,
                   const Steps& st, const Plan& p, int vector, cudaStream_t stream) {
  int max_step = 0;
  for (int b = 0; b < n; ++b) max_step = std::max(max_step, st.s[b]);
  if (p.halo > max_step) return cudaErrorInvalidValue;
  constexpr int N = Vec<T>::N;  // channels per 16-byte staging copy
  if (vector) {
    const void* ptrs[] = {x, y, w};
    if (!vector_ok(C, N, ptrs, 3) || p.group % N != 0) return cudaErrorInvalidValue;
  }
  const int V = vector ? 4 : 1;  // channels per walker
  if (p.threads % (p.group / V) != 0 || p.threads > kMaxThreads) return cudaErrorInvalidValue;
  const int hp = (H + p.g - 1) / p.g, wp = (W + p.g - 1) / p.g;
  const int64_t staged = static_cast<int64_t>(p.tile_h + 2 * p.halo) *
                         (p.tile_w + 2 * p.halo) * p.group * sizeof(T);
  const int64_t weights = static_cast<int64_t>(n) * 9 * p.group * sizeof(float);
  if ((staged + 15) / 16 * 16 + weights > p.smem || p.smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const int64_t blocks = static_cast<int64_t>(std::min(p.g, H)) * std::min(p.g, W) *
                         ((hp + p.tile_h - 1) / p.tile_h) * ((wp + p.tile_w - 1) / p.tile_w) *
                         ((C + p.group - 1) / p.group);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool full = p.halo == max_step;
  auto kernel = vector ? (full ? &aspp_phase_kernel<T, 4, true> : &aspp_phase_kernel<T, 4, false>)
                       : (full ? &aspp_phase_kernel<T, 1, true> : &aspp_phase_kernel<T, 1, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), H, W, C, n,
      st, p);
  return cudaGetLastError();
}

int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// dilations: n values (1 <= n <= 8) in an array of 8; dtype: 0 = float32,
// 1 = bfloat16; plan: g, tile_h, tile_w, halo, group, threads, smem bytes,
// vector (1: 16-byte staging and 4 channels per walker, 0: one channel at a
// time), as aspp_plan gives it.
extern "C" int aspp_depthwise3x3_multi(const void* x, const void* w, void* y, int H, int W,
                                       int C, int n, const int* dilations, int dtype,
                                       const int* plan, void* stream) {
  if (H < 1 || W < 1 || C < 1 || n < 1 || n > kMaxBranches) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (p.tile_h < 1 || p.tile_w < 1 || p.halo < 0 || p.group < 1 || p.threads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int g = 0;
  for (int b = 0; b < n; ++b) {
    if (dilations[b] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g = gcd_int(dilations[b], g);
  }
  if (p.g != g) return static_cast<int>(cudaErrorInvalidValue);
  Steps st{};
  for (int b = 0; b < n; ++b) st.s[b] = dilations[b] / g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, y, H, W, C, n, st, p, plan[7], s));
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(x, w, y, H, W, C, n, st, p, plan[7], s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
