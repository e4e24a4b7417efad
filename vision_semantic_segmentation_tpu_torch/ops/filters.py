"""Small spatial filters for BEV map post-processing.

Port of ``vision_semantic_segmentation_tpu/ops/filters.py``: the renderer's
OpenCV filtering (ref renderer.py:175-189 ``apply_filter`` /
``cv2.filter2D`` with a 3x3 box kernel and BORDER_REFLECT_101).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect101_pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Pad the two leading (H, W) axes of (H, W) or (H, W, C) by one cell,
    reflect-101 (``jnp.pad(mode="reflect")``, cv2 BORDER_REFLECT_101)."""
    if x.ndim == 2:
        return F.pad(x[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    # (H, W, C) -> (1, C, H, W) for F.pad's trailing-dims convention
    xp = F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="reflect")
    return xp[0].permute(1, 2, 0)


def box_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter with reflect-101 borders on (H, W) or (H, W, C).

    Matches ``cv2.filter2D(src, -1, ones(3,3)/9)`` (ref renderer.py:175-189),
    as nine shifted adds in the JAX package's order, then ``/ 9``.
    """
    xp = reflect101_pad_hw(x.float())
    h, w = x.shape[0], x.shape[1]
    acc = torch.zeros_like(xp[1 : 1 + h, 1 : 1 + w])
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + xp[dy : dy + h, dx : dx + w]
    out = acc / 9.0
    if not x.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(x.dtype)


def apply_filter(grid: torch.Tensor) -> torch.Tensor:
    """Smooth the (H, W, C) count grid to fill black holes (ref mapping.py:332)."""
    return box_filter_3x3(grid)
