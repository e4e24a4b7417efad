"""Image resizing with the reference's exact semantics.

Port of ``vision_semantic_segmentation_tpu/ops/resize.py``.  Three resize
flavours whose pixel grids all differ:

  * ``F.interpolate(..., mode='bilinear', align_corners=True)`` inside the
    network (ref models/deeplab_v3_plus.py:69, aspp.py:88, decoder.py:47)
  * ``cv2.resize(..., INTER_AREA)`` for camera-image downscale
    (ref vision_semantic_segmentation_node.py:92-96)
  * ``cv2.resize(..., INTER_NEAREST)`` for label upsample (ref node:109)

The bilinear and area modes are two separable 1-D interpolation matrices
applied by f32 matmul, built with numpy exactly as the JAX package builds
them.  ``F.interpolate`` is not used: torch's area mode is not cv2's
INTER_AREA at non-integer ratios, and the matrices keep both packages on
one arithmetic.  Layout is (..., H, W, C), as in the JAX package.

The resizes read their matrices from :func:`_device_matrix`, which keeps
each on the device it is used on: a copy from pageable host memory on every
call would wait for the card's stream to drain, and hold the host there
while a frame's work is queued.  A CUDA graph reads them by address, so its
capture collects them (:func:`held_matrices`) and keeps them alive however
the cache evicts or is cleared.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List, NamedTuple

import numpy as np
import torch

from ..utils.benchmark import span


@functools.lru_cache(maxsize=256)
def _align_corners_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix with align_corners=True.

    Grid: src = i * (in-1)/(out-1); torch's align_corners semantics.
    """
    M = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        M[0, 0] = 1.0
        return M
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (src - lo).astype(np.float32)
    M[np.arange(out_size), lo] += 1.0 - frac
    M[np.arange(out_size), hi] += frac
    return M


@functools.lru_cache(maxsize=256)
def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging matrix reproducing cv2 INTER_AREA downscale.

    Output cell i integrates the source interval [i*s, (i+1)*s), s = in/out,
    with fractional end pixels weighted by their overlap.
    """
    M = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        left = i * scale
        right = (i + 1) * scale
        j0 = int(np.floor(left))
        j1 = int(np.ceil(right))
        for j in range(j0, min(j1, in_size)):
            overlap = min(right, j + 1) - max(left, j)
            if overlap > 0:
                M[i, j] = overlap
        M[i] /= M[i].sum()
    return M.astype(np.float32)


_MATRICES = {"align_corners": _align_corners_matrix, "area": _area_matrix}


@functools.lru_cache(maxsize=256)
def _device_matrix(kind: str, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The (out, in) f32 matrix of ``kind`` (``'align_corners'`` or
    ``'area'``) on ``device``, one tensor a key.

    Built and copied once, at the key's first call (the copy may wait for
    the card, inside ``span("resize.upload")``); on a CPU device the tensor
    is a view of the host matrix."""
    with span("resize.upload"):
        m = torch.from_numpy(_MATRICES[kind](in_size, out_size))
        return m if device.type == "cpu" else m.to(device)


class MatrixCacheInfo(NamedTuple):
    hits: int
    uploads: int


def matrix_cache_info() -> MatrixCacheInfo:
    """Lookups of :func:`_device_matrix` that found their matrix (``hits``)
    and those that built and copied it (``uploads``), since the process
    started or the cache was last cleared."""
    info = _device_matrix.cache_info()
    return MatrixCacheInfo(info.hits, info.misses)


_holding = threading.local()


@contextlib.contextmanager
def held_matrices() -> Iterator[List[torch.Tensor]]:
    """The matrices every resize on this thread reads while open, in a list.

    For the capture of a CUDA graph, which reads them by address at each
    replay: the graph keeps the list, so a matrix evicted from or cleared
    out of :func:`_device_matrix`'s cache is not freed under it."""
    held: List[torch.Tensor] = []
    outer = getattr(_holding, "matrices", None)
    _holding.matrices = held
    try:
        yield held
    finally:
        _holding.matrices = outer


def _separable_resize(x: torch.Tensor, mh: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """Apply 1-D resize matrices ``mh``, ``mw`` (f32, on ``x``'s device)
    along the H and W axes of (..., H, W, C) f32.

    In f32 also under ``torch.autocast`` (bf16 training), as the JAX package
    resizes in f32 whatever the compute dtype."""
    held = getattr(_holding, "matrices", None)
    if held is not None:
        held += (mh, mw)
    with torch.autocast(x.device.type, enabled=False):
        x = torch.einsum("oh,...hwc->...owc", mh, x)
        return torch.einsum("ow,...hwc->...hoc", mw, x)


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (..., H, W, C) tensors."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = _separable_resize(x.float(), _device_matrix("align_corners", in_h, out_h, x.device),
                          _device_matrix("align_corners", in_w, out_w, x.device))
    return y.to(x.dtype)


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_AREA downscale on (..., H, W, C) tensors (ref node:92-96)."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    if out_h > in_h or out_w > in_w:
        raise ValueError("INTER_AREA path is for downscaling")
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = _separable_resize(x.float(), _device_matrix("area", in_h, out_h, x.device),
                          _device_matrix("area", in_w, out_w, x.device))
    if not x.dtype.is_floating_point:
        # cv2 rounds to nearest when storing back to integer images
        y = torch.round(y)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_NEAREST resize on (..., H, W) or (..., H, W, C) (ref node:109).

    A gather (no arithmetic on values), so label images survive exactly.
    """
    out_h, out_w = out_hw
    chan = x.ndim >= 3
    in_h = x.shape[-3] if chan else x.shape[-2]
    in_w = x.shape[-2] if chan else x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    src_r = torch.clamp(torch.arange(out_h, device=x.device) * in_h // out_h, max=in_h - 1)
    src_c = torch.clamp(torch.arange(out_w, device=x.device) * in_w // out_w, max=in_w - 1)
    if chan:
        return x[..., src_r[:, None], src_c[None, :], :]
    return x[..., src_r[:, None], src_c[None, :]]
