"""P1 and P2: the dilated depthwise 3x3 with its taps summed column-major.

Replaces the probe kernels of ``scripts/probe_depthwise_hoist.py``:
``hoisted`` (P1) and ``hoisted_variant`` (P2, ``kind`` "f32col" or "slab").
The three compute one function, K3's (``depthwise.py``) with the nine terms
added column-major (``tj`` outer, ``ti`` inner) in f32, so they differ from
K3 by float summation order only.  The CUDA source is
``csrc/depthwise_hoist.cu``: ``hoisted`` and "f32col" run its register
kernel (K3's layout), "slab" its shared-memory kernel, which stages an f32
tile of the input with its ``2 * dilation`` halo before the nine taps.

The probes' ``w_chunk`` argument is not taken: it sized the TPU's VMEM
chunks along W and changes no value.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, ptr, refuse_grad, uses_plain
from .depthwise import _DTYPES, _check_input, _weights9

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# hoisted and hoisted_variant "f32col" launch one kernel and share its count
HOISTED = CudaKernel("hoisted", "depthwise_hoist.cu", "depthwise_hoist_register", _ARGTYPES)
VARIANTS = {
    "f32col": HOISTED,
    "slab": CudaKernel("hoisted_variant_slab", "depthwise_hoist.cu",
                       "depthwise_hoist_slab", _ARGTYPES),
}


def hoisted_plain(x: torch.Tensor, w9: torch.Tensor, dilation: int) -> torch.Tensor:
    """Plain PyTorch version: nine shifted multiply-adds in f32, column-major taps.

    ``x`` is (1, H, W, C); ``w9`` is (9, C) f32 (tap-major, row-major taps).
    """
    d = dilation
    _, h, w, _ = x.shape
    xp = F.pad(x[0].float(), (0, 0, d, d, d, d))
    acc = None
    for tj in range(3):
        for ti in range(3):
            term = xp[ti * d : ti * d + h, tj * d : tj * d + w] * w9[ti * 3 + tj]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)[None]


def _run(kernel: CudaKernel, x: torch.Tensor, weights: torch.Tensor, dilation: int):
    _check_input(x)
    _, h, w, c = x.shape
    w9 = _weights9(weights, x, dilation)
    if uses_plain(kernel, x):
        return hoisted_plain(x, w9, dilation)
    refuse_grad(kernel, x, w9)
    if not x.is_contiguous():
        raise ValueError(f"{kernel.name} needs a contiguous NHWC input")
    y = torch.empty_like(x)
    kernel.launch(ptr(x), ptr(w9), ptr(y), h, w, c, dilation, _DTYPES[x.dtype])
    return y


def hoisted(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """P1: depthwise 3x3, stride 1, pad = dilation, taps summed column-major.

    ``x`` is (1, H, W, C) f32 or bf16, ``kernel`` (3, 3, 1, C); returns
    (1, H, W, C) in x's dtype.
    """
    return _run(HOISTED, x, kernel, dilation)


def hoisted_variant(x: torch.Tensor, kernel: torch.Tensor, dilation: int,
                    kind: str) -> torch.Tensor:
    """P2: the same function as :func:`hoisted`; ``kind`` picks the design.

    "f32col" runs :func:`hoisted`'s register kernel, "slab" the
    shared-memory kernel (dilation at most 56: its halo must fit a block's
    shared memory).
    """
    if kind not in VARIANTS:
        raise ValueError(f"unknown kind {kind!r} (f32col|slab)")
    return _run(VARIANTS[kind], x, kernel, dilation)
