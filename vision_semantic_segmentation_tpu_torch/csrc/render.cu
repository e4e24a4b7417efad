// Fused BEV finalize for Hopper (sm_90a): reflect-101 3x3 mean per channel,
// strict-> running argmax over channels, zero-evidence mask, packed RGBA.
//
// Replaces the TPU kernel vision_semantic_segmentation_tpu/ops/pallas/render.py
// :: render_bev_map_fused (body _render_kernel).  Arithmetic order is that
// kernel's: horizontal 3-tap sum ((a + b) + c), vertical 3-tap sum of those
// (row r-1, r, r+1), times 1/9 in f32; the channel total accumulates
// c = 0..C-1.  Every add and multiply is an explicitly rounded intrinsic, so
// no FMA contraction changes a bit and the result equals the plain PyTorch
// version exactly.
//
// Bound on the H100: bytes.  It reads the (C, H, W) f32 grid once and writes
// (H, W) int32 (96 MB at 5x2000x2000, 28.7 us at 3.35 TB/s); the arithmetic
// (about 7 flops per input value) is far below the f32 rate.
//
// Design: a strip walk with every channel in flight.
// * Each thread owns kCols = 4 adjacent columns and walks a strip of rows;
//   a warp covers 128 columns, a block kWarps warps side by side.  Per row
//   it issues the float4 loads of all its channel-rows before using any, and
//   keeps the horizontal sums of the two previous rows in registers, so each
//   input row is read once per strip (plus one row above and below it).
// * The left and right neighbour columns come from warp shuffles; only lane
//   0 and lane 31 load one scalar each.  Reflect-101 is a select applied by
//   the threads that hold column 0 or W - 1, and once per row for the
//   strip's first and last rows: no per-cell index math, no division.
// * Output goes out as one int4 (four packed colours) per thread and row.
// * Up to kChunk channels sit in registers; a grid with more channels runs
//   the same walk per chunk of kChunk and reloads the rows above and below
//   for each chunk.  A W that is not a multiple of 4, or a grid or output
//   that is not 16-byte aligned, takes the scalar-load instantiation.
// Time: about 0.040 ms at 5x2000x2000 with 16-row strips, 70 % of the byte
// bound (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, section
// 6), where staging one channel at a time in shared memory took 0.12-0.14 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps per block, side by side along a row
constexpr int kCols = 4;    // adjacent columns per thread (one float4)
constexpr int kChunk = 8;   // channel-rows held in registers at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// Horizontal sums (x[c-1] + x[c]) + x[c+1] of one row of channels
// ch0..ch0+kC-1 at this thread's columns col0..col0+kCols-1.
template <int kC, bool kVec>
__device__ __forceinline__ void hsum_row(const float* __restrict__ grid, size_t plane, int C,
                                         int ch0, int W, int row, int col0, int lane,
                                         float (&h)[kC][kCols]) {
  float e[kC][kCols + 2];  // x[col0 - 1 .. col0 + kCols]
  const float* base = grid + static_cast<size_t>(row) * W;
#pragma unroll
  for (int k = 0; k < kC; ++k) {  // every load of the row before any use
    const bool ok = ch0 + k < C;
    const float* src = base + static_cast<size_t>(ch0 + k) * plane;
    if constexpr (kVec) {  // W % 4 == 0: the thread's columns are all in or all out
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ok && col0 < W) q = *reinterpret_cast<const float4*>(src + col0);
      e[k][1] = q.x;
      e[k][2] = q.y;
      e[k][3] = q.z;
      e[k][4] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) e[k][j + 1] = ok && col0 + j < W ? src[col0 + j] : 0.0f;
    }
    e[k][0] = ok && lane == 0 && col0 > 0 && col0 <= W ? src[col0 - 1] : 0.0f;
    e[k][kCols + 1] = ok && lane == 31 && col0 + kCols < W ? src[col0 + kCols] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const float left = __shfl_up_sync(kFull, e[k][kCols], 1);
    const float right = __shfl_down_sync(kFull, e[k][1], 1);
    if (lane > 0) e[k][0] = left;
    if (lane < 31) e[k][kCols + 1] = right;
    if (col0 == 0) e[k][0] = e[k][2];  // reflect-101: x[-1] = x[1]
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (col0 + j == W - 1) e[k][j + 2] = e[k][j];  // x[W] = x[W - 2]
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) h[k][j] = __fadd_rn(__fadd_rn(e[k][j], e[k][j + 1]), e[k][j + 2]);
  }
}

template <int kC, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    render_kernel(const float* __restrict__ grid, const int32_t* __restrict__ colors, int C,
                  int H, int W, int strip, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kWarps * 32 + threadIdx.x) * kCols;
  const int r0 = blockIdx.y * strip;
  const int r1 = min(r0 + strip, H);
  const size_t plane = static_cast<size_t>(H) * W;
  const bool rolls = C <= kC;  // one chunk: rows r-1 and r stay in registers
  float ha[kC][kCols], hb[kC][kCols], hc[kC][kCols];
  for (int r = r0; r < r1; ++r) {
    float best[kCols], total[kCols];
    int32_t packed[kCols];
    for (int ch0 = 0; ch0 < C; ch0 += kC) {
      if (!rolls || r == r0) {
        hsum_row<kC, kVec>(grid, plane, C, ch0, W, reflect101(r - 1, H), col0, lane, ha);
        hsum_row<kC, kVec>(grid, plane, C, ch0, W, r, col0, lane, hb);
      }
      hsum_row<kC, kVec>(grid, plane, C, ch0, W, reflect101(r + 1, H), col0, lane, hc);
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        if (ch0 + k >= C) break;
        const int32_t color = colors[ch0 + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float sm = __fmul_rn(__fadd_rn(__fadd_rn(ha[k][j], hb[k][j]), hc[k][j]),
                                     1.0f / 9.0f);
          if (ch0 + k == 0) {
            best[j] = sm;
            packed[j] = color;
            total[j] = sm;
          } else {
            if (sm > best[j]) {  // strict: ties keep the lower channel (argmax)
              best[j] = sm;
              packed[j] = color;
            }
            total[j] = __fadd_rn(total[j], sm);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kC; ++k) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          ha[k][j] = hb[k][j];
          hb[k][j] = hc[k][j];
        }
      }
    }
    int32_t v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = total[j] != 0.0f ? packed[j] : 0;
    int32_t* dst = out + static_cast<size_t>(r) * W + col0;
    if constexpr (kVec) {
      if (col0 < W) *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (col0 + j < W) dst[j] = v[j];
      }
    }
  }
}

template <int kC>
cudaError_t launch(const float* grid, const int32_t* colors, int C, int H, int W, int strip,
                   int32_t* out, bool vec, cudaStream_t stream) {
  const dim3 blocks((W + kWarps * 32 * kCols - 1) / (kWarps * 32 * kCols),
                    (H + strip - 1) / strip);
  if (vec) {
    render_kernel<kC, true><<<blocks, kWarps * 32, 0, stream>>>(grid, colors, C, H, W, strip, out);
  } else {
    render_kernel<kC, false><<<blocks, kWarps * 32, 0, stream>>>(grid, colors, C, H, W, strip, out);
  }
  return cudaGetLastError();
}

}  // namespace

// strip: rows each thread walks (the wrapper's STRIP_ROWS).
extern "C" int render_bev_map_fused(const void* grid, const void* colors, int C, int H, int W,
                                    int strip, void* out, void* stream) {
  if (C < 1 || H < 2 || W < 2 || strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(grid);
  const int32_t* col = static_cast<const int32_t*>(colors);
  int32_t* o = static_cast<int32_t*>(out);
  const bool vec = W % kCols == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C < kChunk ? C : kChunk) {
    case 1: err = launch<1>(g, col, C, H, W, strip, o, vec, s); break;
    case 2: err = launch<2>(g, col, C, H, W, strip, o, vec, s); break;
    case 3: err = launch<3>(g, col, C, H, W, strip, o, vec, s); break;
    case 4: err = launch<4>(g, col, C, H, W, strip, o, vec, s); break;
    case 5: err = launch<5>(g, col, C, H, W, strip, o, vec, s); break;
    case 6: err = launch<6>(g, col, C, H, W, strip, o, vec, s); break;
    case 7: err = launch<7>(g, col, C, H, W, strip, o, vec, s); break;
    default: err = launch<kChunk>(g, col, C, H, W, strip, o, vec, s); break;
  }
  return static_cast<int>(err);
}
