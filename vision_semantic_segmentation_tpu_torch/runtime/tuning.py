"""Measurement helpers shared by ``profile`` and (later) ``autotune``.

Port of the helpers of ``vision_semantic_segmentation_tpu/runtime/tuning.py``
that ``runtime/profiling.py`` uses: a seeded random network
(:func:`init_state_dict`), synthetic frame windows drawn on the device
(:func:`generate_windows`), the fused runner's timing
(:func:`time_fused_runner`) and the ``'auto'`` distortion rule
(:func:`_resolve_distortion`).  The autotuner itself (``tune``,
``overlay_yaml``, ``write_overlay``) waits for the ``autotune`` command
(ROADMAP queue 1 item 5).

Timing discipline: frames are made on the device (host staging would time
the transport), each timed region starts and ends with
``torch.cuda.synchronize()`` and ends with a small readback of the grid,
best of ``repeats``, host clock.  Timing does not depend on the weights'
values, so seeded random weights stand in for a checkpoint.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..mapping import PCD_ORIGIN_OFFSET
from ..models.build import build_model

__all__ = ["init_state_dict", "generate_windows", "time_fused_runner"]


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_state_dict(net_cfg, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = "cuda", seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random state dict of ``net_cfg``'s network on ``device``: the JAX
    package's initialisers (He-normal fan-out convs, identity BatchNorm)
    drawn from a CPU ``torch.Generator`` seeded ``seed``, so the values do
    not depend on the device."""
    model = build_model(net_cfg, dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


def generate_windows(
    cfg,
    image_hw: Tuple[int, int],
    window: int,
    n_windows: int,
    seed: int = 100,
    device: DeviceLike = "cuda",
) -> List[Dict[str, torch.Tensor]]:
    """Distinct frame windows inside the configured boundary, made on ``device``.

    The JAX package's footprint and pose: points land in a span of
    ``2 * MAPPING.PCD.RANGE_MAX`` (a frame's worst-case footprint, clipped
    to 0.8 of the boundary) inset by 0.1 of the boundary from its lower
    corner, with the vehicle just behind it facing +x (camera1 sees them).
    The JAX function's overrides of span, inset and pose serve ``bench.py``
    alone and are not ported.  Window ``i`` is drawn from a
    ``torch.Generator`` on the device seeded ``seed + i``: the same shapes
    and ranges as the JAX package's windows, not its random numbers.

    Each window holds image (T, H, W, 3) uint8, pcd (T, 4, bucket) f32
    (x, y, z, intensity), valid (T, bucket), position (T, 3) and
    quaternion (T, 4).
    """
    dev = resolve_device(device)
    bucket = int(cfg.MAPPING.POINT_BUCKET)
    (bx0, bx1), (by0, by1) = cfg.MAPPING.BOUNDARY
    range_max = float(cfg.MAPPING.PCD.RANGE_MAX)
    # the span shrinks for small test grids; the margin keeps points interior
    span = float(min(2.0 * range_max, 0.8 * (bx1 - bx0), 0.8 * (by1 - by0)))
    x0m = bx0 + 0.1 * (bx1 - bx0) - float(PCD_ORIGIN_OFFSET[0])
    y0m = by0 + 0.1 * (by1 - by0) - float(PCD_ORIGIN_OFFSET[1])
    position = torch.tensor([[x0m - 6.0, y0m + span / 2.0, 0.0]], device=dev).repeat(window, 1)
    quaternion = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev).repeat(window, 1)
    lo = torch.tensor([[x0m], [y0m], [-1.0], [0.0]], device=dev)
    hi = torch.tensor([[x0m + span], [y0m + span], [0.5], [20.0]], device=dev)
    img_h, img_w = image_hw

    windows = []
    for i in range(n_windows):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        images = torch.randint(0, 256, (window, img_h, img_w, 3), generator=gen,
                               device=dev, dtype=torch.uint8)
        u = torch.rand((window, 4, bucket), generator=gen, device=dev)
        windows.append({
            "image": images,
            "pcd": lo + u * (hi - lo),
            "valid": torch.ones((window, bucket), dtype=torch.bool, device=dev),
            "position": position,
            "quaternion": quaternion,
        })
    sync(dev)
    return windows


def time_fused_runner(pipeline, windows: List[dict], window: int, camera: str,
                      repeats: int) -> Tuple[float, float]:
    """Time a ``FusedFramePipeline``'s window runner; returns ``(fps, warmup_s)``.

    The first window runs once untimed (cuDNN's algorithm choice, the
    allocator); then every window runs in turn, best of ``repeats``, with
    the grid threaded through and read back at the end.  The JAX function
    also takes the image size to compile its runner for; the port runs
    eagerly and needs none.
    """
    dev = pipeline.device
    sync(dev)
    t0 = time.perf_counter()
    grid = pipeline.run_window(pipeline.init_grid(), windows[0], camera=camera)
    float(grid[:2, :2].sum())
    warmup_s = time.perf_counter() - t0

    elapsed = float("inf")
    for _ in range(max(1, repeats)):
        sync(dev)
        start = time.perf_counter()
        for frames in windows:
            grid = pipeline.run_window(grid, frames, camera=camera)
        sync(dev)
        float(grid[:2, :2].sum())  # readback barrier
        elapsed = min(elapsed, time.perf_counter() - start)
    return (window * len(windows)) / elapsed, warmup_s


def _resolve_distortion(cfg, engine, camera: str, image_hw: Tuple[int, int],
                        distortion: str) -> str:
    """``'auto'`` -> ``'points'`` iff the cfg asks for undistortion AND the
    timed image size matches the camera's calibration (the plumb-bob model
    on points against a frame of another size would time a meaningless
    gather); else ``'none'``.  Any other value is returned as it is."""
    if distortion != "auto":
        return distortion
    undistort = bool(getattr(cfg.VISION_SEM_SEG, "UNDISTORT", True))
    cam = engine.cameras.get(camera)
    calibrated = (
        cam is not None
        and cam.dist is not None
        and cam.im_size is not None
        and tuple(cam.im_size) == (image_hw[1], image_hw[0])  # im_size is (w, h)
    )
    return "points" if (undistort and calibrated) else "none"
