"""K1: fused BEV finalize (smooth + argmax + palette) -> packed RGBA.

Replaces the TPU kernel ``vision_semantic_segmentation_tpu/ops/pallas/
render.py::render_bev_map_fused``; the CUDA source is ``csrc/render.cu``.
On the H100 it is bound by bytes: the (C, H, W) f32 grid is read once and
the (H, W) packed colours written once.  Each thread owns four adjacent
columns and walks a strip of ``STRIP_ROWS`` rows with all channels' loads
in flight, keeping the two previous rows' horizontal sums and the running
argmax in registers; neighbour columns come from warp shuffles and the
reflect-101 border from selects at the edges (no padded copy in device
memory).  The packed palette is copied to the card once per palette and
device, not per call.

The packed value is the TPU kernel's uint32 (little-endian RGBA, alpha
0xFF) held in an int32, because torch's uint32 lacks bitwise ops; alpha sets
the sign bit, so :func:`unpack_rgba_image` masks after shifting.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._lib import CudaKernel, ptr, uses_plain

KERNEL = CudaKernel(
    "render_bev_map_fused", "render.cu", "render_bev_map_fused",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)
STRIP_ROWS = 16  # rows each thread walks (tuned on the card)


def pack_colors(label_colors) -> np.ndarray:
    """(C, 3) RGB -> (C,) packed little-endian RGBA (alpha 255) as int32 bits."""
    c = np.asarray(label_colors, dtype=np.uint32)
    packed = c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | np.uint32(0xFF000000)
    return packed.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def _device_colors(packed: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(packed, dtype=np.int32).copy()).to(device)


def render_bev_map_plain(grid: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version in the kernel's arithmetic order.

    Per channel: reflect-101 pad, horizontal 3-tap sum, vertical 3-tap sum,
    times 1/9; then a strict-``>`` running argmax (ties keep the lower
    channel) and a zero-total mask.  ``colors`` is the (C,) packed int32.
    """
    num_classes, h, w = grid.shape
    planar = torch.nn.functional.pad(grid[None], (1, 1, 1, 1), mode="reflect")[0]
    best = best_packed = total = None
    for c in range(num_classes):
        plane = planar[c]
        horiz = plane[:, 0:w] + plane[:, 1 : w + 1] + plane[:, 2 : w + 2]
        sm = (horiz[0:h] + horiz[1 : h + 1] + horiz[2 : h + 2]) * (1.0 / 9.0)
        if best is None:
            best = sm
            best_packed = colors[c].expand(h, w)
            total = sm
        else:
            better = sm > best
            best = torch.where(better, sm, best)
            best_packed = torch.where(better, colors[c], best_packed)
            total = total + sm
    return torch.where(total != 0.0, best_packed, torch.zeros_like(best_packed))


def render_bev_map_fused(grid: torch.Tensor, label_colors) -> torch.Tensor:
    """Smooth + argmax-render a planar (C, H, W) f32 grid -> (H, W) int32.

    Equivalent to ``render_bev_map(apply_filter(grid))`` (ref
    mapping.py:332-334) up to float order; :func:`unpack_rgba_image` turns
    the packed result into (H, W, 3) uint8.
    """
    if grid.ndim != 3 or grid.dtype != torch.float32:
        raise ValueError(f"expected a (C, H, W) float32 grid, got {tuple(grid.shape)} {grid.dtype}")
    num_classes, h, w = grid.shape
    if num_classes != len(label_colors) or h < 2 or w < 2:
        raise ValueError(f"grid {tuple(grid.shape)} vs {len(label_colors)} colours")
    colors = _device_colors(pack_colors(label_colors).tobytes(), grid.device)
    if uses_plain(KERNEL, grid):
        return render_bev_map_plain(grid, colors)
    if not grid.is_contiguous():
        raise ValueError("render_bev_map_fused needs a contiguous grid")
    out = torch.empty((h, w), dtype=torch.int32, device=grid.device)
    KERNEL.launch(ptr(grid), ptr(colors), num_classes, h, w, STRIP_ROWS, ptr(out))
    return out


def unpack_rgba_image(packed: torch.Tensor) -> torch.Tensor:
    """(H, W) packed int32 -> (H, W, 3) uint8 RGB."""
    return torch.stack(
        [(packed & 0xFF), ((packed >> 8) & 0xFF), ((packed >> 16) & 0xFF)], dim=-1
    ).to(torch.uint8)
