"""Image remapping (undistortion) on the frame's device.

Port of ``vision_semantic_segmentation_tpu/ops/warp.py``: the per-frame
``cv2.undistort`` of the camera image (ref
vision_semantic_segmentation_node.py:85-87) becomes a bilinear gather
through an inverse distortion map computed once per camera
(``geometry.Camera.undistort_maps``).  Plain PyTorch: the JAX package
computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch


def remap_bilinear(image: torch.Tensor, map_xy: torch.Tensor,
                   fill_value: float = 0.0) -> torch.Tensor:
    """Sample ``image`` at float coordinates, like ``cv2.remap(INTER_LINEAR)``.

    Args:
        image: (H, W, C) source image.
        map_xy: (2, H_out, W_out) source (x, y) coordinates per output pixel.
        fill_value: value for samples outside the source (cv2 border constant).
    Returns:
        (H_out, W_out, C) in image's dtype; integer images are rounded.
    """
    h, w, c = image.shape
    map_xy = map_xy.to(device=image.device, dtype=torch.float32)
    sx = map_xy[0].reshape(-1)
    sy = map_xy[1].reshape(-1)
    out_h, out_w = map_xy.shape[1], map_xy.shape[2]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[:, None]
    fy = (sy - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    img_f = image.float().reshape(-1, c)
    fill = torch.tensor(fill_value, dtype=torch.float32, device=image.device)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        return torch.where(inside[:, None], img_f[idx], fill)

    out = (
        tap(x0i, y0i) * (1 - fx) * (1 - fy)
        + tap(x0i + 1, y0i) * fx * (1 - fy)
        + tap(x0i, y0i + 1) * (1 - fx) * fy
        + tap(x0i + 1, y0i + 1) * fx * fy
    )
    out = out.reshape(out_h, out_w, c)
    if not image.dtype.is_floating_point:
        out = torch.round(out)
    return out.to(image.dtype)


def undistort(image: torch.Tensor, undistort_map: torch.Tensor) -> torch.Tensor:
    """Undistort a camera frame using a precomputed (2, H, W) inverse map."""
    return remap_bilinear(image, undistort_map)
