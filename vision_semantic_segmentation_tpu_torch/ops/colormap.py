"""Palette <-> label conversions.

Port of ``vision_semantic_segmentation_tpu/ops/colormap.py``.  The
reference tags 3-D points with RGB colours gathered from the semantic image
and matches them back to class indices by exact equality (ref
mapping.py:387,414-424), and renders maps by palette lookup (ref
data/utils/mapillary_visualization.py:70-89).
"""
from __future__ import annotations

import numpy as np
import torch


def apply_color_map(labels: torch.Tensor, palette) -> torch.Tensor:
    """Class-index image (H, W) -> RGB (H, W, 3) uint8 via palette gather."""
    palette = torch.as_tensor(np.asarray(palette, dtype=np.uint8), device=labels.device)
    return palette[labels.long()]


def colors_to_labels(rgb: torch.Tensor, palette, fill: int = -1) -> torch.Tensor:
    """RGB colours (..., 3) -> int32 class indices by exact palette match.

    The first matching palette entry wins; no match gives ``fill``.
    """
    palette = torch.as_tensor(np.asarray(palette), device=rgb.device).to(rgb.dtype)
    eq = torch.all(rgb[..., None, :] == palette, dim=-1)  # (..., C)
    idx = torch.argmax(eq.to(torch.int32), dim=-1)
    matched = torch.any(eq, dim=-1)
    return torch.where(matched, idx, fill).to(torch.int32)
