"""The row-sharded BEV grid.

Port of ``vision_semantic_segmentation_tpu/parallel/grid_shard.py``.  The
full-route map reaches 5000x7000x5 cells (ref README.md:173-177), 700 MB in
f32.  Here the planar grid's row axis (the map x/boundary axis) is split
over a mesh axis: :class:`ShardedGrid` keeps one contiguous (C, H/k, W)
band per shard on that shard's device (the JAX array with
``P(None, 'grid')``), the cheap per-point math runs once per distinct
device, and every band adds only the points that fall inside it.  No
traffic between bands while the grid accumulates (cell ownership routes
the updates); one gather when the map is rendered or saved.

The per-band update is the engine's own (``_build_dense_update``: K2's
fold, both ``duplicate_semantics``, the lane boost and confidence
weights), so every band behaves as the single-device step does.  A cell
belongs to one band, so per-band dedupe is global dedupe.

Windowed mode (``MAPPING.UPDATE_WINDOW`` > 0): every band computes the same
global pose-centred window from all updated points, then updates its
band's intersection with it on a slab gathered and written back through
index tensors (nothing is read back to the host).

Each band is its own tensor: K2 takes only a contiguous grid, and a row
slice of a planar grid is not one.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import DeviceLike
from .mesh import Mesh, NamedSharding, P, distinct, psum


class ShardedGrid:
    """A planar (C, H, W) grid as row bands: ``bands[i]`` holds rows
    ``[i * b, (i + 1) * b)`` as a contiguous (C, b, W) tensor on the i-th
    device along the mesh's grid axis."""

    def __init__(self, bands: Sequence[torch.Tensor]):
        self.bands = list(bands)

    @property
    def shape(self):
        c, b, w = self.bands[0].shape
        return (c, b * len(self.bands), w)

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.bands]

    def gather(self, device: Optional[DeviceLike] = None) -> torch.Tensor:
        """The full (C, H, W) grid as one tensor on ``device`` (default: the
        first band's)."""
        device = torch.device(device) if device is not None else self.bands[0].device
        return torch.cat([b.to(device) for b in self.bands], dim=1)

    def add_(self, grid: Union[torch.Tensor, np.ndarray, "ShardedGrid"]) -> "ShardedGrid":
        """Add a full grid (or another sharded grid's bands), band by band."""
        if isinstance(grid, ShardedGrid):
            parts = grid.bands
        else:
            grid = torch.as_tensor(grid)
            if tuple(grid.shape) != self.shape:
                raise ValueError(f"grid {tuple(grid.shape)} added to a sharded {self.shape}")
            b = self.bands[0].shape[1]
            parts = [grid[:, i * b:(i + 1) * b] for i in range(len(self.bands))]
        for band, part in zip(self.bands, parts):
            band += part.to(band.device)
        return self


def init_sharded_grid(engine, mesh: Mesh, axis: str = "grid") -> ShardedGrid:
    """Allocate the planar (C, H, W) grid row-sharded over ``axis``: each
    band on its own device."""
    spec = engine.grid_spec
    k = mesh.shape[axis]
    if spec.height % k:
        raise ValueError(f"grid rows {spec.height} must divide into {k} shards")
    shape = (spec.num_classes, spec.height // k, spec.width)
    return ShardedGrid([torch.zeros(shape, dtype=torch.float32, device=d)
                        for d in mesh.along(axis)])


def shard_grid(grid, mesh: Mesh, axis: str = "grid") -> ShardedGrid:
    """A full (C, H, W) grid (a tensor or an array) laid out as
    :func:`init_sharded_grid` lays a fresh one out; the bands are copies."""
    grid = torch.as_tensor(grid)
    devices = mesh.along(axis)
    k = len(devices)
    if grid.ndim != 3 or grid.shape[1] % k:
        raise ValueError(f"grid rows of {tuple(grid.shape)} must divide into {k} shards")
    b = grid.shape[1] // k
    bands = []
    for i, d in enumerate(devices):
        band = torch.empty((grid.shape[0], b, grid.shape[2]), dtype=torch.float32, device=d)
        bands.append(band.copy_(grid[:, i * b:(i + 1) * b]))
    return ShardedGrid(bands)


def gather_grid(grid_sharded: ShardedGrid, device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Materialize the full grid on one device (render/eval path)."""
    return grid_sharded.gather(device)


def make_band_updater(engine, nshards: int) -> Callable:
    """Per-frame update of one shard's (C, band, W) row band.

    Returns ``update(grid_band, shard_id, cell, cls, intensity, upd,
    weights=None) -> grid_band`` applying the engine's dense update to the
    band in place (or, in ``MAPPING.UPDATE_WINDOW`` mode, to the band's
    intersection with the pose-centred global window, through a slab).
    One closure serves every band, on whatever device it lives.  Shared
    by the grid-sharded step and the composed sharded-grid + frame-parallel
    runner, so every path keeps identical duplicate/window semantics.
    """
    dense_update = engine._build_dense_update()
    spec = engine.grid_spec
    h, w = spec.height, spec.width
    if h % nshards:
        raise ValueError(f"grid rows {h} must divide into {nshards} shards")
    band = h // nshards

    win = int(engine.update_window) if engine.update_window else 0
    windowed = 0 < win < max(h, w)
    # global window extents (as engine._build_update) and the per-band
    # slab extents
    win_r = min(win, h)
    win_c = min(win, w)
    slab_r = min(win_r, band)

    def update(grid_band, shard_id, cell, cls, intensity, upd, weights=None):
        row = cell // w
        col = cell % w
        local_row = row - shard_id * band
        in_band = (local_row >= 0) & (local_row < band)
        ok = upd & in_band

        if not windowed:
            local_cell = local_row * w + col
            return dense_update(grid_band, local_cell, cls, intensity, ok, band, w,
                                weights=weights)

        # global window centre from ALL updated points: every band computes
        # the same r0/c0
        n_upd = torch.clamp(upd.sum(), min=1)
        r_mean = torch.where(upd, row, 0).sum() // n_upd
        c_mean = torch.where(upd, col, 0).sum() // n_upd
        r0 = torch.clamp(r_mean - win_r // 2, 0, max(h - win_r, 0))
        c0 = torch.clamp(c_mean - win_c // 2, 0, max(w - win_c, 0))
        # as the unsharded window: only points inside the GLOBAL window are
        # applied (the band's slab may extend past it)
        in_gwin = (row >= r0) & (row < r0 + win_r) & (col >= c0) & (col < c0 + win_c)

        # this band's slab: covers the window's rows in the band (possibly more)
        r0_local = torch.clamp(r0 - shard_id * band, 0, band - slab_r)
        lr = local_row - r0_local
        lc = col - c0
        in_slab = (lr >= 0) & (lr < slab_r) & (lc >= 0) & (lc < win_c)
        ok_w = ok & in_gwin & in_slab
        local_cell = lr * win_c + lc

        rows = (r0_local + torch.arange(slab_r, device=grid_band.device))[:, None]
        cols = (c0 + torch.arange(win_c, device=grid_band.device))[None, :]
        slab = grid_band[:, rows, cols].contiguous()
        dense_update(slab, local_cell, cls, intensity, ok_w, slab_r, win_c, weights=weights)
        grid_band[:, rows, cols] = slab
        return grid_band

    return update


def _frame_on(device: torch.device, pcd, valid, image, position, quaternion, weights=None):
    """One frame's inputs as tensors on ``device`` (the dtypes engine.step
    gives them)."""
    def to(x, dtype=None):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return x.to(device=device, dtype=dtype or x.dtype,
                    non_blocking=device.type == "cuda")

    return (to(pcd, torch.float32), to(valid, torch.bool), to(image),
            to(position, torch.float32), to(quaternion, torch.float32),
            None if weights is None else to(weights, torch.float32))


def _check_bands(grid_sharded: ShardedGrid, devices: List[torch.device]) -> None:
    if grid_sharded.devices != devices:
        raise ValueError(f"sharded grid on {[str(d) for d in grid_sharded.devices]}, "
                         f"the mesh's bands on {[str(d) for d in devices]}")


def make_sharded_step(
    engine,
    mesh: Mesh,
    axis: str = "grid",
    camera: str = "camera1",
    pcd_in_velodyne_frame: bool = False,
    confidence_weighting: bool = False,
) -> Callable:
    """Build a frame step whose grid is row-sharded over ``axis``.

    Returns ``step(grid_sharded, pcd, valid, image, position, quaternion)``
    updating the :class:`ShardedGrid` in place and returning it.  The
    pointwise stage runs once per distinct device of the bands; logical
    shards on one device share it.  Matches the single-device
    ``engine.step`` in both duplicate-semantics modes.

    With ``confidence_weighting`` the step takes a trailing (N,) per-point
    ``weights`` argument and applies the engine's confidence-weighted
    update; every cell is owned by exactly one band, so the semantics are
    the unsharded ``weights=`` path's.
    """
    devices = mesh.along(axis)
    update_band = make_band_updater(engine, len(devices))
    pointwise = {d: engine._build_pointwise(camera, pcd_in_velodyne_frame, device=d)
                 for d in distinct(devices)}

    def step(grid_sharded, pcd, valid, image, position, quaternion, *wts):
        if len(wts) != int(confidence_weighting):
            raise TypeError(f"the step takes {int(confidence_weighting)} weights argument(s)")
        _check_bands(grid_sharded, devices)
        for dev in pointwise:
            pcd_d, valid_d, image_d, pos_d, quat_d, w = _frame_on(
                dev, pcd, valid, image, position, quaternion, *wts)
            cell, cls, vis, upd = pointwise[dev](pcd_d, valid_d, image_d, pos_d, quat_d)
            for shard_id, band_dev in enumerate(devices):
                if band_dev == dev:
                    update_band(grid_sharded.bands[shard_id], shard_id, cell, cls,
                                pcd_d[3], upd, weights=w)
        return grid_sharded

    return step


def make_sharded_frame_parallel_run(
    engine,
    mesh: Mesh,
    data_axis: str = "data",
    grid_axis: str = "grid",
    camera: str = "camera1",
    pcd_in_velodyne_frame: bool = False,
    confidence_weighting: bool = False,
) -> Callable:
    """Sharded grid x frame parallelism composed over a 2-D mesh.

    Grid rows shard over ``grid_axis`` (memory scales), frames over
    ``data_axis`` (per-frame contributions add,
    ``parallel/frame_parallel.py``).  The shard at (d, g) folds data shard
    d's frames, in recorded order, into a zero partial of band g; one
    :func:`~.mesh.psum` over ``data_axis`` adds the partials per band.
    Exact up to f32 re-association of the per-band sum.

    Returns ``run(grid_sharded, pcds, valids, images, positions,
    quaternions[, weights])``: the frame arrays are stacked on a leading
    axis that the ``data_axis`` size divides (split into contiguous blocks,
    as ``shard_map`` splits it); the grid's bands gain the sums in place.
    Windowed mode is honoured per frame.
    """
    sub = mesh.submesh(data_axis, grid_axis)
    n_data, n_grid = sub.devices.shape
    band_devices = list(sub.devices[0])
    all_devices = distinct(sub.devices.flat)
    update_band = make_band_updater(engine, n_grid)
    pointwise = {d: engine._build_pointwise(camera, pcd_in_velodyne_frame, device=d)
                 for d in all_devices}
    frames_sharding = NamedSharding(sub, P(data_axis))

    def run(grid_sharded, pcds, valids, images, positions, quaternions, *weights):
        if len(weights) != int(confidence_weighting):
            raise TypeError(f"the runner takes {int(confidence_weighting)} weights argument(s)")
        _check_bands(grid_sharded, band_devices)
        dtypes = (torch.float32, torch.bool, None, torch.float32, torch.float32, torch.float32)
        blocks = [frames_sharding.split(x, dt) for x, dt in
                  zip((pcds, valids, images, positions, quaternions) + weights, dtypes)]
        partials = np.empty((n_data, n_grid), dtype=object)
        for d in range(n_data):
            for g in range(n_grid):
                partials[d, g] = torch.zeros_like(grid_sharded.bands[g],
                                                  device=sub.devices[d, g])
            for t in range(blocks[0][d, 0].shape[0]):
                points = {}  # the pointwise stage once per distinct device
                for g in range(n_grid):
                    dev = sub.devices[d, g]
                    if dev not in points:
                        pcd, valid, image, pos, quat, *w = (b[d, g][t] for b in blocks)
                        points[dev] = (pointwise[dev](pcd, valid, image, pos, quat), pcd[3],
                                       w[0] if w else None)
                    (cell, cls, vis, upd), intensity, w = points[dev]
                    update_band(partials[d, g], g, cell, cls, intensity, upd, weights=w)
        totals = psum(sub, partials, data_axis)
        for g, band in enumerate(grid_sharded.bands):
            band += totals[0, g]
        return grid_sharded

    return run
