"""BEV map rendering.

Port of ``render_bev_map`` from ``vision_semantic_segmentation_tpu/mapping/
renderer.py`` (ref renderer.py:32-59), with ``apply_filter``: together the
unfused finalize that K1 (``ops/kernels/render.py``) fuses.  The
threshold/fill/stitch renderers are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import apply_filter

# Default palette of the 5 mapped classes (ref renderer.py:19-25)
LABEL_COLORS = np.array(
    [
        [128, 64, 128],   # road
        [140, 140, 200],  # crosswalk
        [255, 255, 255],  # lane
        [107, 142, 35],   # vegetation
        [244, 35, 232],   # sidewalk
    ],
    dtype=np.uint8,
)

__all__ = ["LABEL_COLORS", "apply_filter", "render_bev_map"]


def render_bev_map(grid: torch.Tensor, label_colors) -> torch.Tensor:
    """Colour each (H, W, C) cell by its argmax channel; zero-sum cells black."""
    colors = torch.as_tensor(np.asarray(label_colors, dtype=np.uint8), device=grid.device)
    if grid.ndim != 3 or grid.shape[2] != colors.shape[0]:
        raise ValueError(f"grid {tuple(grid.shape)} vs {colors.shape[0]} colours")
    winner = torch.argmax(grid, dim=2)
    colored = colors[winner]
    known = torch.sum(grid, dim=2) != 0
    return torch.where(known[..., None], colored, torch.zeros_like(colored))
