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
// bit.
//
// Design (phase.cuh): depthwise.cu's phase tiles, with the walkers turned by
// 90 degrees: a walker goes along a row of the tile and feeds the outputs
// of the columns behind, at and ahead of it, so each sum runs column-major.
// The TPU variants differed only in where the input became f32 in VMEM, and
// that is the one difference kept here:
//
// * depthwise_hoist (hoisted, hoisted_variant "f32col"): the tile is staged
//   in the input's type and a walker converts in registers as it loads.
// * depthwise_hoist_slab (hoisted_variant "slab"): the tile is converted
//   while it is staged and held as f32, so a tap is a plain f32 load at
//   twice the shared bytes of a bf16 tile.  (An f32 input gives the two the
//   same kernel.)
//
// Plan, staging, walker and stores are the same code, so the two times say
// what converting per tap costs against converting once.
//
// Bound on the H100: bytes, as depthwise.cu (read x once, write y once):
// at (180, 240, 2048) bf16, 354 MB, 105.7 us at 3.35 TB/s.

#include "phase.cuh"

// dtype: 0 = float32, 1 = bfloat16; plan: int[7], see phase::run
extern "C" int depthwise_hoist(const void* x, const void* w, void* y, int H, int W, int C, int d,
                               int dtype, const int* plan, void* stream) {
  return phase::run</*kDown=*/false, /*kF32Tile=*/false>(x, w, y, H, W, C, d, dtype, plan,
                                                         stream);
}

extern "C" int depthwise_hoist_slab(const void* x, const void* w, void* y, int H, int W, int C,
                                    int d, int dtype, const int* plan, void* stream) {
  return phase::run</*kDown=*/false, /*kF32Tile=*/true>(x, w, y, H, W, C, d, dtype, plan, stream);
}
