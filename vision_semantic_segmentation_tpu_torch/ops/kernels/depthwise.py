"""K3: dilated depthwise 3x3 (stride 1, zero pad = dilation), NHWC.

Replaces the TPU kernel ``vision_semantic_segmentation_tpu/ops/pallas/
depthwise.py::depthwise3x3_dilated``; the CUDA source is
``csrc/depthwise.cu``.  On the H100 it is bound by bytes (read x once, write
y once).  The kernel puts channels on threads, 16 bytes of channels per
thread, so each tap load and the store are coalesced, and leaves the tap
re-reads to L1/L2.  It accumulates in f32 in the TPU kernel's tap order and
rounds once to the input dtype.

Note on bf16: the JAX package's default depthwise path (the shifted form,
``models/layers.py::ShiftedDepthwiseConv``) accumulates in the compute
dtype; the port follows the TPU kernel and accumulates in f32, so in bf16
the two differ by bf16 rounding of the partial sums.  In f32 they agree.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, ptr, uses_plain

KERNEL = CudaKernel(
    "depthwise3x3_dilated", "depthwise.cu", "depthwise3x3_dilated",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def depthwise3x3_dilated_plain(x: torch.Tensor, w9: torch.Tensor, dilation: int) -> torch.Tensor:
    """Plain PyTorch version: nine shifted multiply-adds in f32, row-major taps.

    ``x`` is (1, H, W, C); ``w9`` is (9, C) f32 (tap-major).
    """
    d = dilation
    _, h, w, _ = x.shape
    xp = F.pad(x[0].float(), (0, 0, d, d, d, d))
    acc = None
    for ti in range(3):
        for tj in range(3):
            term = xp[ti * d : ti * d + h, tj * d : tj * d + w] * w9[ti * 3 + tj]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)[None]


def depthwise3x3_dilated(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """Depthwise 3x3, stride 1, pad = dilation (same-size output).

    Args:
        x: (1, H, W, C) feature map, float32 or bfloat16.  A channels-last
            NCHW activation permuted to NHWC is already contiguous.
        kernel: (3, 3, 1, C) depthwise weights (the JAX package's layout).
        dilation: atrous rate (also the per-side zero padding).
    Returns:
        (1, H, W, C) in x's dtype; the caller adds any bias.
    """
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"single-frame NHWC expected, got {tuple(x.shape)}")
    _, h, w, c = x.shape
    if kernel.shape != (3, 3, 1, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match C={c}")
    if dilation < 1:
        raise ValueError(f"dilation {dilation} < 1")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    w9 = kernel.reshape(9, c).to(device=x.device, dtype=torch.float32).contiguous()
    if uses_plain(KERNEL, x):
        return depthwise3x3_dilated_plain(x, w9, dilation)
    if not x.is_contiguous():
        raise ValueError("depthwise3x3_dilated needs a contiguous NHWC input")
    y = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(w9), ptr(y), h, w, c, dilation, _DTYPES[x.dtype])
    return y
