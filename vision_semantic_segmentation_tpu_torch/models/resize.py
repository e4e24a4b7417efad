"""NCHW adapter for the NHWC resizes in ``ops/resize.py``."""
from __future__ import annotations

import torch

from ..ops.resize import resize_align_corners


def resize_nchw(x: torch.Tensor, out_hw) -> torch.Tensor:
    """align_corners=True bilinear resize of (N, C, H, W) in the input dtype.

    The permutes are views; the result is channels-last in memory.
    """
    return resize_align_corners(x.permute(0, 2, 3, 1), tuple(out_hw)).permute(0, 3, 1, 2)
