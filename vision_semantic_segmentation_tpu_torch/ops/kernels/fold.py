"""K2: evidence fold ``grid += E @ obs`` in place.

Replaces the TPU kernel ``vision_semantic_segmentation_tpu/ops/pallas/
fold.py::evidence_fold_add``; the CUDA source is ``csrc/fold.cu``.  On the
H100 it is bound by bytes (read grid and obs, write grid: 3 * C * 4 bytes
per cell).  The kernel takes E by value in its parameter space and moves
four cells per thread as 16-byte vectors; the C * C products stay in
registers, and no (C, H*W) delta is ever materialised.

The launch is the operator ``vss_torch::evidence_fold_add`` (it mutates
``grid``; its CUDA impl launches K2 and counts the launch, its CPU impl is
the plain version), so ``torch.export`` keeps it as one node of an
exported frame step (``runtime/export.py``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ._lib import OPS, CudaKernel, ptr, uses_plain

KERNEL = CudaKernel(
    "evidence_fold_add", "fold.cu", "evidence_fold_add",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_void_p],
)
MAX_CLASSES = 8


def evidence_fold_add_plain(grid: torch.Tensor, obs: torch.Tensor, evidence: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version: the ordered C*C multiply-adds, in place."""
    num_cls = grid.shape[0]
    for c in range(num_cls):
        acc = grid[c].clone()
        for i in range(num_cls):
            acc = acc + float(evidence[c, i]) * obs[i]
        grid[c] = acc
    return grid


def evidence_fold_add_(grid: torch.Tensor, obs: torch.Tensor, evidence) -> torch.Tensor:
    """``grid += evidence @ obs`` on planar (C, H, W) f32 tensors, in place.

    Args:
        grid: (C, H, W) f32 grid, updated in place and returned.
        obs: (C, H, W) f32 per-class observation planes.
        evidence: (C, C) host array; column i is the additive evidence when
            class i is observed (ref mapping.py:424).
    """
    e = np.ascontiguousarray(np.asarray(evidence, dtype=np.float32))
    num_cls = grid.shape[0]
    if grid.ndim != 3 or obs.shape != grid.shape or e.shape != (num_cls, num_cls):
        raise ValueError(f"shapes grid {tuple(grid.shape)} obs {tuple(obs.shape)} E {e.shape}")
    if grid.dtype != torch.float32 or obs.dtype != torch.float32:
        raise ValueError("evidence_fold_add_ takes float32 grid and obs")
    if obs.device != grid.device:
        raise ValueError("grid and obs must share a device")
    if not uses_plain(KERNEL, grid):
        if not (grid.is_contiguous() and obs.is_contiguous()):
            raise ValueError("evidence_fold_add_ needs contiguous grid and obs")
        if num_cls > MAX_CLASSES:
            raise ValueError(f"evidence_fold_add_ takes at most {MAX_CLASSES} classes")
    torch.ops.vss_torch.evidence_fold_add(grid, obs, [float(v) for v in e.reshape(-1)])
    return grid


def _evidence(grid: torch.Tensor, evidence: Sequence[float]) -> np.ndarray:
    return np.asarray(evidence, dtype=np.float32).reshape(grid.shape[0], grid.shape[0])


def _fold_cuda(grid: torch.Tensor, obs: torch.Tensor, evidence: Sequence[float]) -> None:
    e = _evidence(grid, evidence)
    if KERNEL.plain_on_cuda:
        evidence_fold_add_plain(grid, obs, e)
        return
    # E is read on the host by the launcher (kernel parameter space)
    KERNEL.launch(ptr(grid), ptr(obs), ctypes.c_void_p(e.ctypes.data), grid.shape[0],
                  grid[0].numel())


def _fold_cpu(grid: torch.Tensor, obs: torch.Tensor, evidence: Sequence[float]) -> None:
    evidence_fold_add_plain(grid, obs, _evidence(grid, evidence))


OPS.define("evidence_fold_add(Tensor(a!) grid, Tensor obs, float[] evidence) -> ()")
OPS.impl("evidence_fold_add", _fold_cuda, "CUDA")
OPS.impl("evidence_fold_add", _fold_cpu, "CPU")


@torch.library.register_fake("vss_torch::evidence_fold_add", lib=OPS)
def _fold_fake(grid, obs, evidence) -> None:
    return None
