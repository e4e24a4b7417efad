"""P1 and P2: the dilated depthwise 3x3 with its taps summed column-major.

Replaces the probe kernels of ``scripts/probe_depthwise_hoist.py``:
``hoisted`` (P1) and ``hoisted_variant`` (P2, ``kind`` "f32col" or "slab").
The three compute one function, K3's (``depthwise.py``) with the nine terms
added column-major (``tj`` outer, ``ti`` inner) in f32, so they differ from
K3 by float summation order only.  The CUDA source is
``csrc/depthwise_hoist.cu``: K3's phase tiles (``csrc/phase.cuh``) with the
walkers going along the rows, which gives each sum its column-major order.
The TPU variants differed in where the input became f32, and so do these:
``hoisted`` and "f32col" stage the tile in the input's type and convert as
a walker loads (one kernel, one launch count); "slab" converts while
staging and holds the tile as f32.  Plan, walker and stores are shared, so
their two times say what the conversion per tap costs.

The probes' ``w_chunk`` argument is not taken: it sized the TPU's VMEM
chunks along W and changes no value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._lib import CudaKernel, refuse_grad, uses_plain
from .depthwise import (
    DEPTHWISE_ARGTYPES,
    _check_input,
    _weights9,
    depthwise_plan,
    launch_depthwise,
    pointers_aligned,
)

# hoisted and hoisted_variant "f32col" launch one kernel and share its count
HOISTED = CudaKernel("hoisted", "depthwise_hoist.cu", "depthwise_hoist", DEPTHWISE_ARGTYPES)
VARIANTS = {
    "f32col": HOISTED,
    "slab": CudaKernel("hoisted_variant_slab", "depthwise_hoist.cu", "depthwise_hoist_slab",
                       DEPTHWISE_ARGTYPES),
}


def staged_itemsize(kernel: CudaKernel, x: torch.Tensor) -> int:
    """Bytes of a staged element: 4 where the kernel holds its tile as f32."""
    return 4 if kernel is VARIANTS["slab"] else x.element_size()


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
    plan = depthwise_plan(h, w, c, dilation, x.element_size(), staged_itemsize(kernel, x),
                          aligned=pointers_aligned(x, w9))
    return launch_depthwise(kernel, x, w9, dilation, plan)


def hoisted(x: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """P1: depthwise 3x3, stride 1, pad = dilation, taps summed column-major.

    ``x`` is (1, H, W, C) f32 or bf16, ``kernel`` (3, 3, 1, C); returns
    (1, H, W, C) in x's dtype.
    """
    return _run(HOISTED, x, kernel, dilation)


def hoisted_variant(x: torch.Tensor, kernel: torch.Tensor, dilation: int,
                    kind: str) -> torch.Tensor:
    """P2: the same function as :func:`hoisted`; ``kind`` picks the design.

    "f32col" runs :func:`hoisted`'s kernel (the tile staged in x's dtype),
    "slab" the kernel that stages the tile as f32.
    """
    if kind not in VARIANTS:
        raise ValueError(f"unknown kind {kind!r} (f32col|slab)")
    return _run(VARIANTS[kind], x, kernel, dilation)
