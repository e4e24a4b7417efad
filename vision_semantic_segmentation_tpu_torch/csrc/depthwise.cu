// Dilated depthwise 3x3 convolution for Hopper (sm_90a): stride 1, zero pad
// = dilation, NHWC, f32 accumulation, output in the input dtype.
//
// Replaces the TPU kernel vision_semantic_segmentation_tpu/ops/pallas/
// depthwise.py :: depthwise3x3_dilated (bodies _kernel, _kernel_slab_f32).
// Arithmetic order is that kernel's: taps in row-major order (ti, then tj),
// each term x * w rounded in f32, the first term starting the sum, each
// later term added with a rounded f32 add (explicit intrinsics: no FMA
// contraction).  Out-of-image taps contribute 0 * w exactly like the padded
// reference, so the result equals the plain PyTorch version, and the
// matching branch of aspp_depthwise.cu, bit for bit in f32 and after the
// final rounding to bf16.
//
// Bound on the H100: bytes.  At ASPP's (180, 240, 2048) bf16 it must read
// 177 MB and write 177 MB (~106 us at 3.35 TB/s) while doing 18 flops per
// output element (~24 us at the 67 TFLOP/s f32 rate).
//
// Design (phase.cuh): a block stages one tile of one phase x[pr::d, pc::d]
// for a group of channels in shared memory, in the input's type and with a
// zero border of one phase pixel, and walkers go down its columns, each
// staged row loaded once for the three outputs that use it.  The input
// leaves HBM once whatever the dilation is.  No TPU-only constraint is kept
// (C % 128, w_out rounded to 8, VMEM budgets): any H, W, C and dilation
// run, with one channel per thread when C does not fill 16-byte copies or a
// pointer is not 16-byte aligned.

#include "phase.cuh"

// dtype: 0 = float32, 1 = bfloat16; plan: int[7], see phase::run
extern "C" int depthwise3x3_dilated(const void* x, const void* w, void* y, int H, int W, int C,
                                    int d, int dtype, const int* plan, void* stream) {
  return phase::run</*kDown=*/true, /*kF32Tile=*/false>(x, w, y, H, W, C, d, dtype, plan, stream);
}
