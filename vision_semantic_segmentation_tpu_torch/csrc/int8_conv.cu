// Q1: int8 3x3 convolution with the requantize epilogue, for Hopper (sm_90a).
//
// A port-only kernel: the JAX package runs its int8 convs through XLA's
// conv_general_dilated with preferred_element_type=int32
// (vision_semantic_segmentation_tpu/models/quant.py:72-78, :380-392), and no
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
// __fadd_rn: no FMA contraction) and the int32 sum is exact (|acc| <= 4,608
// * 127^2 < 2^31 at the backbone's widest K), so the kernel equals its plain
// PyTorch version (an f64 conv of the int8 values, exact below 2^53, then
// the same f32 epilogue) bit for bit.
//
// Bound on the H100: bytes at every site of the backbone.  At ResNeXt50-32x4d
// OS8 on a 1440x1920 frame its 16 sites move 786 MB (each input, weight and
// output byte once): 234.8 us at 3.35 TB/s, against 62.5 us for their 63 G
// int8 multiply-adds at 1,979 TOPS.  So the design reads each input and
// output byte from device memory about once (halo re-reads come from L2)
// and feeds the tensor cores from shared memory:
//
// - An implicit GEMM per K tile: M = output pixels, N = the tile's output
//   channels, K = 9 taps x its input channels in the weights' tap-major
//   order, on mma.sync m16n8k32 s8 (IMMA).  A K tile is one group, or gpt
//   groups of 4 or 8 channels (at most 8 out) with block-diagonal weights:
//   then a tap's 32 input channels are 32 contiguous staged bytes and an
//   n8 tile holds real columns, for gpt times the products (ResNeXt's
//   layer1 and layer2: 288-deep K, n32, in place of 36 padded to 64 by n4
//   padded to n8).  K padding and the diagonal's outside meet zero weights,
//   whatever A holds there.
// - A fragments: with 16 or 32 channels of a tap in a K chunk, an 8x16-byte
//   row of an ldmatrix is 16 channels of one tap at one pixel, so one
//   ldmatrix.x4 loads a 16x32 A fragment; with 4 or 8 channels (groups no
//   K tile takes) each 32-bit register is 4 channels of one tap, one
//   shared load.  B fragments: ldmatrix from the staged [column][K] rows.
// - A block takes a channel block (gb K tiles, or one column slice of a
//   wider K tile) and a run of tpb output tiles (16x16 pixels by default).
//   Per (tile, K chunk) item it stages the tile's input with its halo in
//   dynamic shared memory by cp.async (16 bytes where the channels allow,
//   else 8 or 4; pixels off the image zero-filled with a source size of 0),
//   two stages deep: item i + 1's copies fly while item i multiplies.  With
//   one K chunk (every grouped site) the weights and the epilogue's scale
//   and shift are staged once a block; dense sites loop over 32-channel
//   chunks of K with the chunk's weights in the item.
// - The staged tile's rows are contiguous or three bands (one a tap row,
//   where a large dilation makes that smaller), and its columns are split
//   into stride phases, so the rows of an A fragment are neighbouring
//   staged pixels at stride 2 too.  Pitches are odd multiples of 16 bytes:
//   the 8 rows of a fragment load fall into 8 different 4-bank groups (a
//   128-byte pitch would be an 8-way conflict).
// - A warp task is mt m16 tiles of pixels by nt n8 tiles of one K tile's
//   columns (mt * nt = 8: 32 int32 sums a thread).  The epilogue's
//   arithmetic is the plain version's, in registers; it writes an output
//   tile in shared memory, which the block stores in 16-byte (else 8 or 4)
//   contiguous pieces of a pixel's channels.
// - Loops over copies advance their indices by carries (no division per
//   copy); staged row and column offsets come from two small tables.
//
// ops/kernels/int8_conv.py::q1_plan computes the plan (K tile, tile,
// channel block, K chunk, the staged layout, shared bytes, grid) and passes
// it as ints; the CPU tests walk that plan block by block
// (tests/test_torch_int8_plan.py).  ptxas (-Xptxas -v, CUDA 12.8, sm_90a,
// __launch_bounds__(256, 2)): 108-128 registers an instantiation; no spills
// except <8, 1> (8 bytes stored, 24 loaded), the route of 8-channel groups
// that no K tile takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kOutInt8 = 0;
constexpr int kOutF32 = 1;
constexpr int kOutBF16 = 2;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on the H100

// ops/kernels/int8_conv.py::Q1Plan, field for field
struct Plan {
  int gpt, ck, chunks, nt, mt, n, tile_h, tile_w, tw_shift, tiles_h, tiles_w, tpb, gb, slices,
      cols, cols_p, kpad, tasks, threads;
  int srows, row_a, row_s, row_d, scols, col_a, col_s, col_d, y_step;
  int tap_row[3], tap_col[3];
  int pitch, vec, wvec, wpitch, opitch, ovec;
  int in_stages, in_bytes, w_bytes, w_off, o_off, map_off, ss_off, smem, grid;
};
static_assert(sizeof(Plan) == 49 * sizeof(int), "Q1Plan.c_args() passes 49 ints");

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* shift;
  void* out;
  // cin_g, cout_g and groups of the K tiles (gpt groups each); wcin is a
  // group's own input channels, the weights' inner extent
  int H, W, Cin, Ho, Wo, Cout, cin_g, cout_g, groups, wcin, stride, pad, out_kind, relu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes = 16, 8 or 4; a source size of 0 zero-fills the destination
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool copy) {
  const uint32_t d = smem_addr(dst);
  const int n = copy ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four (two) 8x16-byte matrices: lanes 8i..8i+7 give matrix i's row
// addresses; lane l receives bytes 4 (l % 4) .. + 3 of row l / 4 of each
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a * b: m16n8k32, A row-major (pixels x K), B column-major (K x columns)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int pick3(const int (&v)[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

template <int CK, int NT>
__global__ void __launch_bounds__(kMaxThreads, 2)
int8_conv3x3_kernel(const Args a, const Plan p) {
  constexpr int MT = 8 / NT;
  constexpr int K9 = 9 * CK;
  constexpr int KS = (K9 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragment's row group and lane in it

  // the block: a channel block (fastest) and a run of tpb output tiles
  const int ncb = a.groups / p.gb * p.slices;
  const int cb = blockIdx.x % ncb;
  const int tiles = p.n * p.tiles_h * p.tiles_w;
  const int tile0 = blockIdx.x / ncb * p.tpb;
  const int items = min(p.tpb, tiles - tile0) * p.chunks;
  const int g0 = cb / p.slices * p.gb;
  const int sl = cb % p.slices;
  const int ocols = min(p.cols, a.cout_g - sl * p.cols);  // real columns of the slice
  const int run = p.gb * CK;  // staged bytes of a pixel
  const int wrows = p.gb * p.cols_p;
  const int w_stages = p.chunks > 1 ? 2 : 1;

  // zero the weights no copy writes: the K padding and the padded columns;
  // in a K tile of several groups everything off its diagonal blocks too
  // (the barrier below orders these stores before the copies)
  {
    const int kw = p.kpad / 4;
    for (int i = tid; i < wrows * kw; i += nthreads) {
      const int r = i / kw, k4 = i - r * kw;
      if (p.gpt > 1 || k4 * 4 >= K9 || r % p.cols_p >= ocols) {
        for (int b = 0; b < w_stages; ++b)
          *reinterpret_cast<uint32_t*>(smem + p.w_off + b * p.w_bytes + r * p.wpitch + k4 * 4) =
              0u;
      }
    }
  }
  // the block's epilogue vectors, zero in the padded columns
  float* ssc = reinterpret_cast<float*>(smem + p.ss_off);
  float* ssh = ssc + wrows;
  for (int r = tid; r < wrows; r += nthreads) {
    const int col = r % p.cols_p;
    const int gc = (g0 + r / p.cols_p) * a.cout_g + sl * p.cols + col;
    ssc[r] = col < ocols ? __ldg(a.scale + gc) : 0.0f;
    ssh[r] = col < ocols ? __ldg(a.shift + gc) : 0.0f;
  }

  // the staged rows' and columns' offsets from the tile's origin in the
  // input (contiguous, stride phases or tap bands), once a block
  int* rowmap = reinterpret_cast<int*>(smem + p.map_off);
  int* colmap = rowmap + p.srows;
  for (int i = tid; i < p.srows + p.scols; i += nthreads) {
    if (i < p.srows) {
      rowmap[i] = i % p.row_a * p.row_s + i / p.row_a * p.row_d;
    } else {
      const int c = i - p.srows;
      colmap[c] = c % p.col_a * p.col_s + c / p.col_a * p.col_d;
    }
  }
  __syncthreads();

  // tile index -> image and the tile's first output row and column
  auto tile_at = [&](int tile, int& img, int& oy0, int& ox0) {
    ox0 = tile % p.tiles_w * p.tile_w;
    tile /= p.tiles_w;
    oy0 = tile % p.tiles_h * p.tile_h;
    img = tile / p.tiles_h;
  };

  // item i's input tile (and its chunk's weights) into stage `buf`
  auto stage = [&](int item, int buf) {
    const int j = item % p.chunks;
    int img, oy0, ox0;
    tile_at(tile0 + item / p.chunks, img, oy0, ox0);
    const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
    const long long img_row0 = static_cast<long long>(img) * a.H;
    unsigned char* ib = smem + buf * p.in_bytes;
    // a thread copies one vec-byte unit u of a pixel, `lanes` pixels apart
    const int upp = run / p.vec;
    const int lanes = nthreads / upp;
    const int first = tid / upp;
    if (first < lanes) {
      const int b = tid % upp * p.vec, seg = b / CK;
      const long long chan = static_cast<long long>(g0 + seg) * a.cin_g + j * CK + (b - seg * CK);
      const int dr = lanes / p.scols, dc = lanes - dr * p.scols;
      int r = first / p.scols, c = first - r * p.scols;
      for (int pos = first; pos < p.srows * p.scols; pos += lanes) {
        const int gy = iy0 + rowmap[r], gx = ix0 + colmap[c];
        const bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        const int8_t* src = inside ? a.x + ((img_row0 + gy) * a.W + gx) * a.Cin + chan : a.x;
        cp_async(ib + pos * p.pitch + b, src, p.vec, inside);
        r += dr;
        c += dc;
        if (c >= p.scols) {
          c -= p.scols;
          ++r;
        }
      }
    }
    if (p.chunks == 1 && item > 0) return;  // one chunk: the weights stay staged
    unsigned char* wb = smem + p.w_off + (p.chunks > 1 ? buf : 0) * p.w_bytes;
    // a thread copies one wvec-byte unit of a tap of a row, `wlanes` rows
    // apart; a row's column belongs to group gl of its K tile, whose
    // `piece` channels of each tap sit at gl * piece
    const int piece = CK / p.gpt;
    const int per_tap = piece / p.wvec, per_row = 9 * per_tap;
    const int wlanes = nthreads / per_row;
    const int wfirst = tid / per_row;
    if (wfirst < wlanes) {
      const int tap = tid % per_row / per_tap;
      const int c = tid % per_tap * p.wvec;  // the unit's channel in the piece
      const int dg = wlanes / p.cols_p, dcol = wlanes - dg * p.cols_p;
      int gi = wfirst / p.cols_p, col = wfirst - gi * p.cols_p;
      for (int r = wfirst; r < wrows; r += wlanes) {
        if (col < ocols) {
          const int ce = sl * p.cols + col;  // the column in its K tile
          const long long co = static_cast<long long>(g0 + gi) * a.cout_g + ce;
          const int gl = ce / (a.cout_g / p.gpt);
          cp_async(wb + r * p.wpitch + tap * CK + gl * piece + c,
                   a.w + co * 9 * a.wcin + tap * a.wcin + j * piece + c, p.wvec, true);
        }
        gi += dg;
        col += dcol;
        if (col >= p.cols_p) {
          col -= p.cols_p;
          ++gi;
        }
      }
    }
  };

  // A fragments.  With ck >= 16 a 16-byte row of an m8 x k16 matrix is 16
  // channels of one tap at one pixel, so ldmatrix.x4 loads a whole fragment:
  // lane l gives row (l % 8) + 8 ((l / 8) % 2) at K half (l / 16).  With ck
  // of 4 or 8 a fragment is four 32-bit loads: register (ks, h) of a lane
  // holds K 32 ks + 16 h + 4 t .. + 3 of rows g and g + 8.
  constexpr bool kLdsm = CK >= 16;
  constexpr int HALVES = kLdsm ? 1 : 2;
  const int a_row = kLdsm ? (lane & 7) + 8 * ((lane >> 3) & 1) : g;
  int aoff[KS][HALVES];  // the tap's staged offset plus the channel
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const int k = kLdsm ? ks * 32 + (lane >> 4) * 16 : ks * 32 + h * 16 + t * 4;
      int tap = k / CK, c = k - tap * CK;
      if (tap > 8) {  // K padding: any staged bytes, against zero weights
        tap = 8;
        c = 0;
      }
      aoff[ks][h] = (pick3(p.tap_row, tap / 3) * p.scols + pick3(p.tap_col, tap % 3)) * p.pitch +
                    c;
    }
  }
  // B fragments by ldmatrix: lane l gives weight row l % 8 of n8 tile
  // 2 i + (l / 16) (one tile: l / 16 ignored), K half (l / 8) % 2
  const int b_row = (lane & 7) + (NT > 1 ? 8 * (lane >> 4) : 0);
  const int b_col = 16 * ((lane >> 3) & 1);

  const int mr_n = p.tile_h * p.tile_w / (16 * MT);
  const int nr_n = p.cols_p / (8 * NT);
  const int isz = a.out_kind == kOutInt8 ? 1 : (a.out_kind == kOutF32 ? 4 : 2);
  const int oupp = p.gb * ocols * isz / p.ovec;
  const long long chan0 = static_cast<long long>(g0) * a.cout_g + sl * p.cols;
  unsigned char* otile = smem + p.o_off;
  int acc[MT][NT][4];

  // a two-stage pipeline over the block's (tile, chunk) items: item i + 1's
  // copies are in flight while item i multiplies
  stage(0, 0);
  cp_async_commit();
  for (int item = 0; item < items; ++item) {
    if (item + 1 < items) {
      stage(item + 1, (item + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j = item % p.chunks;
    const unsigned char* ib = smem + (item & 1) * p.in_bytes;
    const unsigned char* wb = smem + p.w_off + (p.chunks > 1 ? item & 1 : 0) * p.w_bytes;
    // with one chunk a warp loops over tasks; with several it has one task
    for (int task = warp; task < p.tasks; task += nwarps) {
      const int mr = task % mr_n, rest = task / mr_n;
      const int nr = rest % nr_n, gi = rest / nr_n;
      if (j == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
      }
      // staged offsets of this lane's fragment rows: a_row (ldmatrix), or
      // g and g + 8
      int rb[MT][HALVES];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          const int pix = (mr * MT + m) * 16 + hh * 8 + a_row;
          const int y = pix >> p.tw_shift, x = pix & (p.tile_w - 1);
          rb[m][hh] = (y * p.y_step * p.scols + x) * p.pitch + gi * CK;
        }
      }
      const uint32_t ib_s = smem_addr(ib);
      const uint32_t wrow =
          smem_addr(wb) + (gi * p.cols_p + nr * 8 * NT + b_row) * p.wpitch + b_col;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bf[NT][2];
        if constexpr (NT == 1) {
          ldsm_x2(wrow + ks * 32, bf[0][0], bf[0][1]);
        } else {
#pragma unroll
          for (int n = 0; n < NT; n += 2)
            ldsm_x4(wrow + n * 8 * p.wpitch + ks * 32, bf[n][0], bf[n][1], bf[n + 1][0],
                    bf[n + 1][1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          if constexpr (kLdsm) {
            ldsm_x4(ib_s + rb[m][0] + aoff[ks][0], af[0], af[1], af[2], af[3]);
          } else {
            af[0] = lds32(ib + rb[m][0] + aoff[ks][0]);
            af[1] = lds32(ib + rb[m][HALVES - 1] + aoff[ks][0]);
            af[2] = lds32(ib + rb[m][0] + aoff[ks][HALVES - 1]);
            af[3] = lds32(ib + rb[m][HALVES - 1] + aoff[ks][HALVES - 1]);
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_s8(acc[m][n], af, bf[n][0], bf[n][1]);
        }
      }
      if (j == p.chunks - 1) {
        // epilogue: c0, c1 are row g, columns 2t, 2t + 1; c2, c3 row g + 8
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = nr * 8 * NT + n * 8 + 2 * t;
          if (col >= ocols) continue;  // ocols is a multiple of 4: both columns or neither
          const float2 sc = *reinterpret_cast<const float2*>(ssc + gi * p.cols_p + col);
          const float2 sh = *reinterpret_cast<const float2*>(ssh + gi * p.cols_p + col);
          const int ch = gi * ocols + col;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              unsigned char* orow = otile + ((mr * MT + m) * 16 + hh * 8 + g) * p.opitch;
              float y[2];
              y[0] = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][n][2 * hh]), sc.x), sh.x);
              y[1] = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][n][2 * hh + 1]), sc.y), sh.y);
              if (a.out_kind == kOutInt8) {
                const int lo = a.relu ? 0 : -127;
                const int q0 = min(max(__float2int_rn(y[0]), lo), 127);
                const int q1 = min(max(__float2int_rn(y[1]), lo), 127);
                *reinterpret_cast<uint16_t*>(orow + ch) =
                    static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
              } else {
                if (a.relu) {
                  y[0] = fmaxf(y[0], 0.0f);
                  y[1] = fmaxf(y[1], 0.0f);
                }
                if (a.out_kind == kOutF32) {
                  *reinterpret_cast<float2*>(orow + ch * 4) = make_float2(y[0], y[1]);
                } else {  // two bf16, the lower channel in the low half
                  *reinterpret_cast<uint32_t*>(orow + ch * 2) =
                      static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y[0]))) |
                      (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(y[1])))
                       << 16);
                }
              }
            }
          }
        }
      }
    }
    if (j == p.chunks - 1) {
      // the finished output tile to device memory, ovec bytes a store
      __syncthreads();
      int img, oy0, ox0;
      tile_at(tile0 + item / p.chunks, img, oy0, ox0);
      const int olanes = nthreads / oupp;  // a thread stores unit u, olanes pixels apart
      const int u = tid % oupp;
      for (int pix = tid / oupp; pix < p.tile_h * p.tile_w && tid < olanes * oupp;
           pix += olanes) {
        const int oy = oy0 + (pix >> p.tw_shift), ox = ox0 + (pix & (p.tile_w - 1));
        if (oy >= a.Ho || ox >= a.Wo) continue;
        unsigned char* dst = static_cast<unsigned char*>(a.out) +
                             (((static_cast<long long>(img) * a.Ho + oy) * a.Wo + ox) * a.Cout +
                              chan0) * isz + u * p.ovec;
        const unsigned char* src = otile + pix * p.opitch + u * p.ovec;
        if (p.ovec == 16) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else if (p.ovec == 8) {
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        } else {
          *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
        }
      }
    }
    __syncthreads();
  }
}

template <int CK, int NT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  // once a card: the largest dynamic shared memory, and the SM's carveout
  // to shared memory, so that several blocks fit an SM
  constexpr int kMaxCards = 64;
  static bool opened[kMaxCards] = {};
  int card = 0;
  cudaError_t err = cudaGetDevice(&card);
  if (err != cudaSuccess) return err;
  if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
  if (!opened[card]) {
    err = cudaFuncSetAttribute(int8_conv3x3_kernel<CK, NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int8_conv3x3_kernel<CK, NT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opened[card] = true;
  }
  int8_conv3x3_kernel<CK, NT><<<p.grid, p.threads, p.smem, stream>>>(a, p);
  return cudaGetLastError();
}

// cin_g, cout_g and groups are the K tiles' (gpt groups each), wcin a group's
bool plan_matches(const Plan& p, int N, int Ho, int Wo, int cin_g, int cout_g, int groups,
                  int wcin, int isz) {
  const bool ck = p.ck == 4 || p.ck == 8 || p.ck == 16 || p.ck == 32;
  const bool nt = (p.nt == 1 || p.nt == 2 || p.nt == 4) && p.mt == 8 / p.nt;
  if (!ck || !nt || cin_g % p.ck || p.chunks != cin_g / p.ck || p.gb < 1 || groups % p.gb)
    return false;
  const int piece = p.ck / p.gpt;  // a group's channels of a tap in a K chunk
  if (p.ck % p.gpt || (p.gpt > 1 && (p.chunks != 1 || piece != wcin)) ||
      (p.wvec != 4 && p.wvec != 8 && p.wvec != 16) || piece % p.wvec)
    return false;
  const int pixels = p.tile_h * p.tile_w;
  if (p.tile_h < 1 || p.tile_w < 16 || p.tw_shift < 4 || p.tw_shift > 10 ||
      p.tile_w != 1 << p.tw_shift || pixels % (16 * p.mt) || p.cols_p % (8 * p.nt) ||
      p.cols < 1 || p.cols_p < p.cols || p.slices != (cout_g + p.cols - 1) / p.cols ||
      (p.slices > 1 && p.gb != 1) || (p.slices == 1 && p.cols != cout_g))
    return false;
  if (p.tasks != p.gb * (p.cols_p / (8 * p.nt)) * (pixels / (16 * p.mt)) || p.threads < 32 ||
      p.threads > kMaxThreads || p.threads % 32 || (p.chunks > 1 && p.threads != 32 * p.tasks))
    return false;
  // the copy loops give each thread one unit of a pixel or weight row
  if (p.gb * p.ck / p.vec > p.threads || 9 * piece / p.wvec > p.threads ||
      p.gb * p.cols * isz / p.ovec > p.threads)
    return false;
  if (p.n != N || p.tiles_h * p.tile_h < Ho || p.tiles_w * p.tile_w < Wo || p.tpb < 1 ||
      p.smem < 1 || p.smem > kMaxSmem || (p.vec != 4 && p.vec != 8 && p.vec != 16) ||
      (p.ovec != 4 && p.ovec != 8 && p.ovec != 16))
    return false;
  const long long tiles = static_cast<long long>(N) * p.tiles_h * p.tiles_w;
  // one input stage only where a block has one item
  if (p.in_stages != 2 && (p.in_stages != 1 || (p.tpb < tiles ? p.tpb : tiles) * p.chunks > 1))
    return false;
  return p.grid == (tiles + p.tpb - 1) / p.tpb * (groups / p.gb) * p.slices;
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does
// not take or a plan that does not match them (the wrapper checks first).
extern "C" int int8_conv3x3(const void* x, const void* w, const void* scale, const void* shift,
                            void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                            int groups, int stride, int pad, int dil, int out_kind, int relu,
                            const void* plan, void* stream) {
  if (groups < 1 || Cin % groups || Cout % groups || N < 1 || Ho < 1 || Wo < 1 ||
      stride < 1 || dil < 1 || pad < 0 || out_kind < kOutInt8 || out_kind > kOutBF16 || !plan)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cin_g = Cin / groups;
  const int cout_g = Cout / groups;
  if (cin_g % 4 || cout_g % 4) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof p);
  if (p.gpt < 1 || groups % p.gpt) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's groups are K tiles of gpt groups, block-diagonal weights
  const int tiles = groups / p.gpt;
  const int isz = out_kind == kOutInt8 ? 1 : (out_kind == kOutF32 ? 4 : 2);
  if (!plan_matches(p, N, Ho, Wo, cin_g * p.gpt, cout_g * p.gpt, tiles, cin_g, isz))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(shift), out, H, W,
               Cin, Ho, Wo, Cout, cin_g * p.gpt, cout_g * p.gpt, tiles, cin_g, stride, pad,
               out_kind, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q1_CASE(CKV, NTV) \
  if (p.ck == CKV && p.nt == NTV) return static_cast<int>(launch<CKV, NTV>(a, p, s));
  Q1_CASE(4, 1) Q1_CASE(4, 2) Q1_CASE(4, 4)
  Q1_CASE(8, 1) Q1_CASE(8, 2) Q1_CASE(8, 4)
  Q1_CASE(16, 1) Q1_CASE(16, 2) Q1_CASE(16, 4)
  Q1_CASE(32, 1) Q1_CASE(32, 2) Q1_CASE(32, 4)
#undef Q1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
