"""Multi-frame / multi-camera grid stitching.

Port of ``vision_semantic_segmentation_tpu/mapping/stitching.py`` (ref
src/stitching.py:21-100): per-frame grids (log-odds channels) or coloured
frames composed into one canvas through chained homographies.  The canvas
extent comes from the warped frame corners on the host; the warps and the
accumulation run on the device of the first frame (a numpy frame: the
CPU), through ``geometry/homography.py::warp_perspective``.

Modes (ref stitching.py:76-98):
  * log-odds: the warped channel grids are summed (bilinear warp);
  * colour: painter's algorithm, later frames overwrite where non-black
    (nearest warp).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..geometry.homography import warp_perspective
from .renderer import LABEL_COLORS, render_bev_map

__all__ = ["stitch_image"]


def _canvas_extent(im_shape: Tuple[int, int],
                   homography_list: Sequence[np.ndarray]) -> Tuple[int, int, int, int]:
    """Min / max canvas coordinates covering every chained-warped frame."""
    h, w = im_shape
    corners = np.array([[w, 0, 0, w], [0, 0, h, h], [1, 1, 1, 1]], dtype=np.float64)
    min_x, min_y, max_x, max_y = 0.0, 0.0, float(w), float(h)
    x_t = corners.copy()
    for H in list(homography_list)[::-1]:
        x_t = np.asarray(H) @ x_t
        pts = x_t[:2] / x_t[2]
        min_x = min(min_x, pts[0].min())
        min_y = min(min_y, pts[1].min())
        max_x = max(max_x, pts[0].max())
        max_y = max(max_y, pts[1].max())
    return int(min_x), int(min_y), int(max_x), int(max_y)


def stitch_image(
    im_src_list: Sequence,
    homography_list: Sequence[np.ndarray],
    log_odds_out: bool = True,
    label_colors: np.ndarray = LABEL_COLORS,
) -> torch.Tensor:
    """Stitch frames into one canvas (ref stitching.py:40-100).

    Args:
        im_src_list: per-frame (H, W, C) grids, tensors or numpy.
        homography_list: frame-to-next-frame homographies; frame i reaches
            the last frame's coordinates through H_i .. H_{n-2}.
        log_odds_out: sum the warped channels (float32); otherwise colour
            each frame by its argmax and composite with the painter's
            algorithm (uint8 RGB).

    As in the reference and the JAX package, the loop runs over
    ``range(len(homography_list) - 1)``: the LAST frame is not drawn (its
    homography only enters the extent).
    """
    if len(im_src_list) != len(homography_list):
        raise ValueError(f"{len(im_src_list)} frames, {len(homography_list)} homographies")
    first = im_src_list[0]
    device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    im_shape = tuple(first.shape[:2])
    min_x, min_y, max_x, max_y = _canvas_extent(im_shape, homography_list)
    out_w, out_h = max_x - min_x, max_y - min_y

    if log_odds_out:
        canvas = torch.zeros((out_h, out_w, first.shape[2]), dtype=torch.float32, device=device)
    else:
        canvas = torch.zeros((out_h, out_w, 3), dtype=torch.uint8, device=device)

    shift = np.eye(3)
    shift[0, 2] = -min_x
    shift[1, 2] = -min_y

    for i in range(len(homography_list) - 1):
        H_chain = np.eye(3)
        for H in homography_list[i:-1]:
            H_chain = np.asarray(H) @ H_chain
        H_total = shift @ H_chain
        src = torch.as_tensor(im_src_list[i]).to(device=device, dtype=torch.float32)
        if log_odds_out:
            canvas = canvas + warp_perspective(src, H_total, (out_w, out_h), mode="bilinear")
        else:
            colored = render_bev_map(src, label_colors)
            warped = warp_perspective(colored, H_total, (out_w, out_h), mode="nearest")
            mask = torch.sum(warped.to(torch.int32), dim=2) != 0
            canvas = torch.where(mask[..., None], warped, canvas)
    return canvas
