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
"""
from __future__ import annotations

import functools

import numpy as np
import torch


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


def _separable_resize(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """Apply 1-D resize matrices along the H and W axes of (..., H, W, C) f32.

    In f32 also under ``torch.autocast`` (bf16 training), as the JAX package
    resizes in f32 whatever the compute dtype."""
    Mh = torch.from_numpy(mh).to(x.device)
    Mw = torch.from_numpy(mw).to(x.device)
    with torch.autocast(x.device.type, enabled=False):
        x = torch.einsum("oh,...hwc->...owc", Mh, x)
        return torch.einsum("ow,...hwc->...hoc", Mw, x)


def resize_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True on (..., H, W, C) tensors."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = _separable_resize(
        x.float(), _align_corners_matrix(in_h, out_h), _align_corners_matrix(in_w, out_w)
    )
    return y.to(x.dtype)


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_AREA downscale on (..., H, W, C) tensors (ref node:92-96)."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[-3], x.shape[-2]
    if out_h > in_h or out_w > in_w:
        raise ValueError("INTER_AREA path is for downscaling")
    if (in_h, in_w) == (out_h, out_w):
        return x
    y = _separable_resize(x.float(), _area_matrix(in_h, out_h), _area_matrix(in_w, out_w))
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
