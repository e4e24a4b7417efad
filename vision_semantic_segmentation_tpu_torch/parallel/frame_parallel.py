"""Frame-parallel offline replay: data parallelism over recorded frames.

Port of ``vision_semantic_segmentation_tpu/parallel/frame_parallel.py``.
The reference replays a drive strictly in order (ref
mapping_replay.py:175-211), but every frame's update is an *addition* of
per-frame evidence into the grid, and the reference's duplicate collapse
applies within one frame only (ref mapping.py:424).  Per-frame
contributions therefore commute:

    frames split over the 'data' axis in contiguous blocks
      -> each shard folds ITS frames, in recorded order, into a zero
         partial grid on its device
      -> one fixed-order psum -> added to the grid

This is exact up to f32 re-association of the sum over shards.  Logical
shards on one device (``create_mesh(devices=["cuda:0"] * 4)``) run one
after another; on several cards each shard's work goes to its own card's
stream.  Combine with ``parallel.grid_shard`` when the grid itself exceeds
one device's memory.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..mapping.engine import pad_points
from .mesh import Mesh, NamedSharding, P, distinct, psum


def make_frame_parallel_run(
    engine,
    mesh: Mesh,
    axis: str = "data",
    camera: str = "camera1",
    pcd_in_velodyne_frame: bool = False,
    confidence_weighting: bool = False,
) -> Callable:
    """Build ``run(grid, pcds, valids, images, positions, quaternions)``.

    The frame arrays are stacked on a leading frame axis that the mesh
    ``axis`` size must divide; shard s takes the s-th contiguous block.
    ``grid`` gains the sum of the partial grids in place and is returned
    (the JAX runner donates it).  ``MAPPING.UPDATE_WINDOW`` is honoured: each
    shard's per-frame update runs on a pose-centred slab of its partial
    grid, as in the unsharded engine.  Devices of other mesh axes would hold
    replicas of the result; the shards along ``axis`` at index 0 of the
    other axes do the work.

    With ``confidence_weighting`` the runner takes a trailing ``weights``
    argument: stacked (T, N) per-point evidence weights, split like the
    frames.
    """
    line = mesh.submesh(axis)
    devices = list(line.devices)
    pointwise = {d: engine._build_pointwise(camera, pcd_in_velodyne_frame, device=d)
                 for d in distinct(devices)}
    apply_update = engine._build_update()
    frames_sharding = NamedSharding(line, P(axis))

    def run(grid, pcds, valids, images, positions, quaternions, *weights):
        if len(weights) != int(confidence_weighting):
            raise TypeError(f"the runner takes {int(confidence_weighting)} weights argument(s)")
        dtypes = (torch.float32, torch.bool, None, torch.float32, torch.float32, torch.float32)
        blocks = [frames_sharding.shard(x, dt) for x, dt in
                  zip((pcds, valids, images, positions, quaternions) + weights, dtypes)]
        partials = []
        for s, dev in enumerate(devices):
            local = torch.zeros(grid.shape, dtype=grid.dtype, device=dev)
            for t in range(blocks[0][s].shape[0]):
                pcd, valid, image, position, quaternion, *w = (b[s][t] for b in blocks)
                cell, cls, vis, upd = pointwise[dev](pcd, valid, image, position, quaternion)
                apply_update(local, cell, cls, pcd[3], upd, weights=w[0] if w else None)
            partials.append(local)
        grid += psum(line, partials, axis)[0].to(grid.device)
        return grid

    return run


def stack_frames(engine, frames, mesh: Mesh, axis: str = "data"):
    """Stack FrameRecords for the frame-parallel runner: pcd (T, 4, N),
    valid (T, N), image (T, H, W, 3), position (T, 3), quaternion (T, 4),
    padded to a multiple of the mesh axis with no-op frames (zero validity,
    cloud, image and position, the identity quaternion).

    The stacks are host tensors, in pinned memory when the mesh holds a
    card, so the runner's copies to the devices do not block the host (as
    ``runtime/replay.py::MappingReplay._stage`` stages a window).
    """
    if not frames:
        raise ValueError("stack_frames: empty frame sequence")
    n_dev = mesh.shape[axis]
    pcds, valids, images, positions, quaternions = [], [], [], [], []
    for f in frames:
        pcd, valid = pad_points(np.asarray(f.pcd, np.float32), engine.point_bucket)
        pcds.append(pcd)
        valids.append(valid)
        images.append(np.asarray(f.semantic_image))
        positions.append(np.asarray(f.position, np.float32))
        quaternions.append(np.asarray(f.quaternion, np.float32))
    while len(pcds) % n_dev:
        pcds.append(np.zeros_like(pcds[0]))
        valids.append(np.zeros_like(valids[0]))
        images.append(np.zeros_like(images[0]))
        positions.append(np.zeros_like(positions[0]))
        quaternions.append(np.array([0, 0, 0, 1], np.float32))
    pin = any(d.type == "cuda" for d in mesh.devices.flat)
    stacked = tuple(torch.from_numpy(np.stack(x))
                    for x in (pcds, valids, images, positions, quaternions))
    return tuple(t.pin_memory() for t in stacked) if pin else stacked
