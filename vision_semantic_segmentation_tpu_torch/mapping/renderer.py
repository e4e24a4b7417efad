"""BEV map rendering on the grid's device.

Port of ``vision_semantic_segmentation_tpu/mapping/renderer.py`` (ref
src/renderer.py:19-197): argmax colouring with zero-evidence cells black
(``render_bev_map``, with ``apply_filter`` the unfused finalize that K1
``ops/kernels/render.py`` fuses), the threshold and priority render,
priority-based black-hole filling, border marking, log-odds -> probability
(the logsumexp path of ref test/test_renderer.py:35-47) and per-class layer
images.  Every function but ``add_car_to_map`` (host numpy, as in the JAX
package) runs where its input tensor lies, in plain PyTorch: the JAX
package renders these outside any Pallas kernel.

Sums and probabilities are computed so that the card and the CPU give the
same bits: a cell's channel sum is added in channel order (not a reduction
whose order a device may choose), and the logsumexp runs in float64 before
the float32 result is rounded, so device ``exp`` implementations that differ
in the last float32 bit do not move a quantised layer image.
"""
from __future__ import annotations

from typing import Optional, Sequence

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

# Black-hole filling priority, low to high (ref renderer.py:67)
FILL_PRIORITY = (0, 3, 4, 2, 1)

__all__ = [
    "LABEL_COLORS",
    "FILL_PRIORITY",
    "add_car_to_map",
    "apply_filter",
    "fill_black",
    "fill_black_mode",
    "fill_edge",
    "log_odds_to_probability",
    "map_layer_images",
    "render_bev_map",
    "render_bev_map_with_thresholds",
    "resume_color",
]


def _colors(label_colors, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(label_colors, dtype=np.uint8), device=device)


def _channel_sum(grid: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 1), the channels added in order."""
    acc = grid[..., 0:1]
    for c in range(1, grid.shape[2]):
        acc = acc + grid[..., c:c + 1]
    return acc


def render_bev_map(grid: torch.Tensor, label_colors) -> torch.Tensor:
    """Colour each (H, W, C) cell by its argmax channel; zero-sum cells black
    (ref renderer.py:32-59)."""
    colors = _colors(label_colors, grid.device)
    if grid.ndim != 3 or grid.shape[2] != colors.shape[0]:
        raise ValueError(f"grid {tuple(grid.shape)} vs {colors.shape[0]} colours")
    winner = torch.argmax(grid, dim=2)
    colored = colors[winner]
    known = torch.sum(grid, dim=2) != 0
    return torch.where(known[..., None], colored, torch.zeros_like(colored))


def render_bev_map_with_thresholds(
    grid: torch.Tensor,
    label_colors,
    priority: Optional[Sequence[int]] = None,
    thresholds: Sequence[float] = (0.01, 0.01, 0.01, 0.01, 0.01),
) -> torch.Tensor:
    """Paint each channel whose share of the cell's sum reaches its threshold.

    Channels are painted in ``priority`` order (a later one overwrites),
    explored cells only (ref renderer.py:131-172).
    """
    colors = _colors(label_colors, grid.device)
    num_channels = grid.shape[2]
    if priority is None:
        priority = list(range(num_channels))
    if len(priority) != num_channels:
        raise ValueError(f"priority {list(priority)} for {num_channels} channels")
    channel_sum = _channel_sum(grid)
    normalized = torch.where(channel_sum != 0,
                             grid / torch.where(channel_sum == 0, 1.0, channel_sum), 0.0)
    known = channel_sum[..., 0] != 0
    colored = torch.zeros((*grid.shape[:2], 3), dtype=torch.uint8, device=grid.device)
    for i, p in enumerate(priority):
        mask = (normalized[..., p] >= thresholds[i]) & known
        colored = torch.where(mask[..., None], colors[p], colored)
    return colored


def _windows_3x3(x: torch.Tensor):
    """The nine shifted (H, W, ...) views of ``x`` zero-padded by one cell,
    row-major over the 3x3 window."""
    h, w = x.shape[0], x.shape[1]
    padded = torch.zeros((h + 2, w + 2, *x.shape[2:]), dtype=x.dtype, device=x.device)
    padded[1:-1, 1:-1] = x
    return [padded[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def fill_black(color_map: torch.Tensor, label_colors=LABEL_COLORS,
               priority: Sequence[int] = FILL_PRIORITY) -> torch.Tensor:
    """Fill cells from their 3x3 neighbourhood by class priority.

    Every class present anywhere in a pixel's 3x3 window paints it, in
    ``priority`` order (higher priority last).  As in the JAX package (ref
    renderer.py:62-98 matches the first channel only and drops the 1-pixel
    border): the canvas keeps its size, a border pixel sees its partial
    window, and a class matches on full RGB.
    """
    colors = _colors(label_colors, color_map.device)
    windows = _windows_3x3(color_map)
    out = torch.zeros_like(color_map)
    for cls in priority:
        color = colors[cls]
        present = torch.zeros(color_map.shape[:2], dtype=torch.bool, device=color_map.device)
        for win in windows:
            present |= torch.all(win == color, dim=-1)
        out = torch.where(present[..., None], color, out)
    return out


def fill_black_mode(color_map: torch.Tensor, label_colors=LABEL_COLORS) -> torch.Tensor:
    """Fill every cell with the most frequent class in its 3x3 window.

    The reference's per-pixel loop (ref renderer.py:108-128
    ``fill_black_for_loop``) as counts of each class over the window, then
    an argmax (a cell with no class in reach stays black).  Ties go to the
    class of the smallest first colour channel, as ``scipy.stats.mode``
    (which sees only that channel) breaks them: the classes are visited in
    the stable ``argsort`` of the first channel and the first maximum wins.
    """
    colors = _colors(label_colors, color_map.device)
    counts = []
    for i in range(colors.shape[0]):
        onehot = torch.all(color_map == colors[i], dim=-1).to(torch.int32)
        acc = torch.zeros_like(onehot)
        for win in _windows_3x3(onehot):
            acc = acc + win
        counts.append(acc)
    counts = torch.stack(counts, dim=-1)  # (H, W, C)
    order = torch.as_tensor(
        np.argsort(np.asarray(label_colors, dtype=np.uint8)[:, 0], kind="stable"),
        device=color_map.device)
    winner = order[torch.argmax(counts[..., order], dim=-1)]
    any_hit = torch.amax(counts, dim=-1) > 0
    out = colors[winner]
    return torch.where(any_hit[..., None], out, torch.zeros_like(out))


def resume_color(gray3: torch.Tensor, label_colors=LABEL_COLORS) -> torch.Tensor:
    """Full RGB back from a first-channel-keyed image (ref renderer.py:101-105)."""
    colors = _colors(label_colors, gray3.device)
    out = gray3
    for i in range(colors.shape[0]):
        mask = gray3[..., 0] == colors[i, 0]
        out = torch.where(mask[..., None], colors[i], out)
    return out


def fill_edge(color_map: torch.Tensor) -> torch.Tensor:
    """A copy with the canvas borders marked (ref renderer.py:192-196)."""
    out = color_map.clone()
    out[[0, -1], :, :] = 250
    out[:, [0, -1], :] = 250
    out[0:5, 0:5] = 254
    return out


def log_odds_to_probability(grid: torch.Tensor) -> torch.Tensor:
    """Per-cell log evidence (H, W, C) -> probabilities by logsumexp over C
    (ref test/test_renderer.py:35-47); float64 inside, float32 out."""
    g = grid.to(torch.float64)
    return torch.exp(g - torch.logsumexp(g, dim=2, keepdim=True)).to(torch.float32)


def map_layer_images(grid: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Per-class grayscale layer images (C, H, W) uint8 of an (H, W, C) grid.

    The headless counterpart of the reference's per-layer matplotlib viewer
    (ref test/test_renderer.py:50-84 ``visualize_map_layer``).
    ``normalize=True`` turns log evidence into probabilities first (ref
    test_renderer.py:35-47); otherwise each layer is min-max scaled.
    """
    grid = torch.as_tensor(grid)
    if normalize:
        scaled = log_odds_to_probability(grid) * 255.0
    else:
        lo = torch.amin(grid, dim=(0, 1), keepdim=True)
        hi = torch.amax(grid, dim=(0, 1), keepdim=True)
        scaled = (grid - lo) / torch.clamp(hi - lo, min=1e-12) * 255.0
    return torch.clamp(scaled, 0, 255).to(torch.uint8).permute(2, 0, 1)


def add_car_to_map(
    color_map: np.ndarray,
    position_rel: np.ndarray,
    yaw_rel: float,
    resolution: float,
    map_boundary,
    length: float = 4.0,
    width: float = 1.8,
    color=(255, 0, 0),
) -> np.ndarray:
    """Paint the ego car's footprint onto a rendered map (ref mapping.py:490-526).

    The reference ships this helper unwired and flagged "not tested, may
    have bug"; the JAX package implements its evident intent, and so does
    this port.  A ``length`` x ``width`` rectangle around the reference's
    car centre rotates by ``yaw_rel`` and translates by ``position_rel``
    (metres, map frame), then paints in the row = x, column = y convention.
    Cells outside the map are clipped.  Host numpy; paints ``color_map`` in
    place and returns it.
    """
    from ..geometry.transforms import rotation_2d

    h, w = color_map.shape[:2]
    mask_length = max(int(length / resolution), 1)
    mask_width = max(int(width / resolution), 1)
    car_center = np.array([[length / 4.0], [width / 2.0]]) / resolution

    ix = np.tile(np.arange(mask_length), mask_width)
    iy = np.repeat(np.arange(mask_width), mask_length)
    ixy = np.vstack([ix, iy]).astype(np.float64)

    R = rotation_2d(float(yaw_rel)).numpy()
    pos = np.asarray(position_rel, dtype=np.float64).reshape(-1)[:2]
    origin = np.array([[-float(map_boundary[0][0]) / resolution], [0.0]])
    ixy_map = (R @ (ixy - car_center) + pos.reshape(2, 1) / resolution + origin).astype(np.int64)

    ok = (ixy_map[0] >= 0) & (ixy_map[0] < h) & (ixy_map[1] >= 0) & (ixy_map[1] < w)
    color_map[ixy_map[0, ok], ixy_map[1, ok]] = np.asarray(color, np.uint8)
    return color_map
