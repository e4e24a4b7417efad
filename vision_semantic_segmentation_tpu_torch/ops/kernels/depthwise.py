"""K3 and K4: dilated depthwise 3x3 (stride 1, zero pad = dilation), NHWC.

K3 replaces the TPU kernel ``vision_semantic_segmentation_tpu/ops/pallas/
depthwise.py::depthwise3x3_dilated``; its CUDA source is
``csrc/depthwise.cu``.  On the H100 it is bound by bytes (read x once, write
y once).  The kernel puts channels on threads, 16 bytes of channels per
thread, so each tap load and the store are coalesced, and leaves the tap
re-reads to L1/L2.  It accumulates in f32 in the TPU kernel's tap order and
rounds once to the input dtype.

K4 replaces ``aspp_depthwise3x3_multi`` of the same TPU module; its CUDA
source is ``csrc/aspp_depthwise.cu``.  It computes every ASPP atrous branch
from one pass over the input, each branch equal to K3 bit for bit, and is
bound by bytes too (one read, one write per branch).

Note on bf16: the JAX package's default depthwise path (the shifted form,
``models/layers.py::ShiftedDepthwiseConv``) accumulates in the compute
dtype; the port follows the TPU kernel and accumulates in f32, so in bf16
the two differ by bf16 rounding of the partial sums.  In f32 they agree.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, ptr, refuse_grad, uses_plain

KERNEL = CudaKernel(
    "depthwise3x3_dilated", "depthwise.cu", "depthwise3x3_dilated",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
MULTI_KERNEL = CudaKernel(
    "aspp_depthwise3x3_multi", "aspp_depthwise.cu", "aspp_depthwise3x3_multi",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)
MAX_BRANCHES = 8  # the CUDA source's kMaxBranches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[0] != 1:
        raise ValueError(f"single-frame NHWC expected, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")


def _weights9(kernel: torch.Tensor, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """(3, 3, 1, C) depthwise weights -> (9, C) f32 on x's device (tap-major)."""
    c = x.shape[-1]
    if kernel.shape != (3, 3, 1, c):
        raise ValueError(f"kernel {tuple(kernel.shape)} does not match C={c}")
    if dilation < 1:
        raise ValueError(f"dilation {dilation} < 1")
    return kernel.reshape(9, c).to(device=x.device, dtype=torch.float32).contiguous()


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
    _check_input(x)
    _, h, w, c = x.shape
    w9 = _weights9(kernel, x, dilation)
    if uses_plain(KERNEL, x):
        return depthwise3x3_dilated_plain(x, w9, dilation)
    refuse_grad(KERNEL, x, w9)
    if not x.is_contiguous():
        raise ValueError("depthwise3x3_dilated needs a contiguous NHWC input")
    y = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(w9), ptr(y), h, w, c, dilation, _DTYPES[x.dtype])
    return y


def aspp_depthwise3x3_multi_plain(
    x: torch.Tensor, w9s: torch.Tensor, dilations: Sequence[int]
) -> List[torch.Tensor]:
    """Plain PyTorch version: K3's plain version per branch, in branch order.

    ``w9s`` is (n, 9, C) f32 (tap-major per branch).
    """
    return [depthwise3x3_dilated_plain(x, w9s[b], d) for b, d in enumerate(dilations)]


def aspp_depthwise3x3_multi(
    x: torch.Tensor, kernels: Sequence[torch.Tensor], dilations: Sequence[int]
) -> List[torch.Tensor]:
    """Every ASPP atrous depthwise branch from one pass over ``x``.

    Equal to ``[depthwise3x3_dilated(x, k, d) for k, d in zip(kernels,
    dilations)]``, bit for bit.

    Args:
        x: (1, H, W, C) feature map, float32 or bfloat16.
        kernels: one (3, 3, 1, C) depthwise kernel per branch (at most 8).
        dilations: one atrous rate per branch (also its zero padding).
    Returns:
        A list of (1, H, W, C) outputs in x's dtype, one per branch; on the
        card they are views of one (n, H, W, C) buffer.
    """
    _check_input(x)
    _, h, w, c = x.shape
    n = len(dilations)
    if not 1 <= n <= MAX_BRANCHES or len(kernels) != n:
        raise ValueError(f"{len(kernels)} kernels for {n} dilations (1..{MAX_BRANCHES})")
    w9s = torch.stack([_weights9(k, x, d) for k, d in zip(kernels, dilations)])
    if uses_plain(MULTI_KERNEL, x):
        return aspp_depthwise3x3_multi_plain(x, w9s, dilations)
    refuse_grad(MULTI_KERNEL, x, w9s)
    if not x.is_contiguous():
        raise ValueError("aspp_depthwise3x3_multi needs a contiguous NHWC input")
    y = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    dil = (ctypes.c_int * MAX_BRANCHES)(*[int(d) for d in dilations])
    MULTI_KERNEL.launch(ptr(x), ptr(w9s), ptr(y), h, w, c, n, ctypes.cast(dil, ctypes.c_void_p),
                        _DTYPES[x.dtype])
    return [y[b : b + 1] for b in range(n)]
