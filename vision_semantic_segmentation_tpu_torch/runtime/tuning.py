"""Workload autotuner for the grid update, and the measurement helpers it
shares with ``profile`` and the serving sweep.

Port of ``vision_semantic_segmentation_tpu/runtime/tuning.py``: a seeded
random network (:func:`init_state_dict`), synthetic frame windows drawn on
the device (:func:`generate_windows`), the fused runner's timing
(:func:`time_fused_runner`), the ``'auto'`` distortion rule
(:func:`_resolve_distortion`) and the autotuner (:func:`tune`,
:func:`overlay_yaml`, :func:`write_overlay`; the ``autotune`` command).
The tuner times the real ``FusedFramePipeline`` at the user's exact
configuration for each ``MAPPING.UPDATE_WINDOW`` candidate (by default the
dense update, 0, and the smallest window that keeps every point of a frame,
``ceil(2.2 * PCD.RANGE_MAX / RESOLUTION)`` cells, where that is smaller
than the grid) and writes a YAML overlay naming the fastest safe one:

    python -m vision_semantic_segmentation_tpu_torch autotune --cfg exp.yaml --out tuned.yaml
    python -m vision_semantic_segmentation_tpu_torch replay --cfg exp.yaml --cfg tuned.yaml ...

The JAX tuner also times each ``FOLD_METHOD``/``SORT_METHOD`` pair; the
port runs one grid update for every such name, so it has nothing there to
choose.

Timing discipline: frames are made on the device (host staging would time
the transport), each timed region starts and ends with
``torch.cuda.synchronize()`` and ends with a small readback of the grid,
best of ``repeats``, host clock.  Timing does not depend on the weights'
values, so seeded random weights stand in for a checkpoint.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..mapping import PCD_ORIGIN_OFFSET
from ..models.build import build_model

__all__ = ["init_state_dict", "generate_windows", "time_fused_runner", "tune",
           "overlay_yaml", "write_overlay"]


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


def _safe_window(cfg) -> int:
    """The smallest pose-centred window (cells) that holds a frame's
    worst-case footprint, ~2.2 * RANGE_MAX / RESOLUTION cells; a smaller one
    drops out-of-window points: faster but not the same map."""
    return math.ceil(2.2 * float(cfg.MAPPING.PCD.RANGE_MAX) / float(cfg.MAPPING.RESOLUTION))


def _default_windows(cfg) -> Tuple[int, ...]:
    """The dense update, and the safe window where it is smaller than the
    grid (the engine runs a window that spans the grid as the dense update)."""
    from ..mapping.engine import GridSpec

    spec = GridSpec.from_cfg(cfg)
    safe = _safe_window(cfg)
    return (0, safe) if safe < max(spec.height, spec.width) else (0,)


def _time_update_window(
    cfg,
    state_dict: Mapping[str, torch.Tensor],
    update_window: int,
    windows: List[dict],
    image_hw: Tuple[int, int],
    window: int,
    camera: str,
    repeats: int,
    distortion: str,
    device: torch.device,
) -> dict:
    """Time the fused runner at one update window (JAX ``_time_combo``)."""
    from ..mapping.engine import SemanticMappingEngine
    from .pipeline import FusedFramePipeline

    row_cfg = cfg.clone()
    row_cfg.defrost()
    row_cfg.MAPPING.UPDATE_WINDOW = uw_val = int(update_window)
    engine = SemanticMappingEngine(row_cfg, device=device)
    # a lossy window never wins (see tune)
    grid_max = max(engine.grid_spec.height, engine.grid_spec.width)
    lossy = 0 < uw_val < min(_safe_window(row_cfg), grid_max)
    dist = _resolve_distortion(row_cfg, engine, camera, image_hw, distortion)
    pipeline = FusedFramePipeline(row_cfg, state_dict, engine=engine, distortion=dist,
                                  device=device)
    fps, warmup_s = time_fused_runner(pipeline, windows, window, camera, repeats)
    return {
        "update_window": uw_val,
        "lossy": lossy,
        "distortion": dist,
        "fps": round(fps, 3),
        "ms_per_frame": round(1000.0 / fps, 3),
        "warmup_s": round(warmup_s, 1),
    }


def tune(
    cfg,
    variables=None,
    image_hw: Tuple[int, int] = (1440, 1920),
    window: int = 16,
    n_windows: int = 2,
    repeats: int = 3,
    update_windows: Optional[Sequence[int]] = None,
    camera: str = "camera1",
    distortion: str = "auto",
    log=None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Time every UPDATE_WINDOW candidate on ``device`` at ``cfg``'s shapes.

    Args:
        cfg: the app config whose MAPPING geometry and bucket define the
          workload; rows override its UPDATE_WINDOW value.
        variables / state_dict: the network's weights (the JAX package's
          flax variables, or a state dict); seeded random weights when
          neither is given (timing does not depend on their values).
        update_windows: UPDATE_WINDOW candidates (cells); ``None`` times
          the dense update and the safe window (see _default_windows).
        distortion: 'auto' | 'none' | 'points' (see _resolve_distortion).

    Returns ``rows`` (one per candidate, in run order), ``best`` (the
    highest fps among rows that keep every point: an update window smaller
    than a frame's worst-case footprint drops points and is timed for
    information only; the earlier row wins a tie) and the workload
    descriptor.  Raises ``ValueError`` when every UPDATE_WINDOW candidate
    is lossy.
    """
    from ..models.convert import flax_to_state_dict

    dev = resolve_device(device)
    if state_dict is None:
        state_dict = (flax_to_state_dict(variables) if variables is not None
                      else init_state_dict(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, device=dev))
    windows = generate_windows(cfg, image_hw, window, n_windows, device=dev)
    rows = []
    for uw in update_windows or _default_windows(cfg):
        row = _time_update_window(cfg, state_dict, uw, windows, image_hw, window, camera,
                                  repeats, distortion, dev)
        rows.append(row)
        if log:
            log(
                f"update_window={row['update_window']:<5} "
                f"{row['fps']:8.2f} fps  ({row['ms_per_frame']:.2f} ms/frame, "
                f"warmup {row['warmup_s']:.0f}s)"
                + ("  [LOSSY: drops out-of-window points]" if row["lossy"] else "")
            )
    safe = [r for r in rows if not r["lossy"]]
    if not safe:
        raise ValueError(
            "every UPDATE_WINDOW candidate is lossy at this config "
            "(needs >= ceil(2.2 * PCD.RANGE_MAX / RESOLUTION) cells, or 0 "
            "for the dense update) — add a safe candidate"
        )
    best = max(safe, key=lambda r: r["fps"])
    return {
        "rows": rows,
        "best": best,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "image_hw": list(image_hw),
        "window": window,
        "n_windows": n_windows,
        "point_bucket": int(cfg.MAPPING.POINT_BUCKET),
        "boundary": [list(b) for b in cfg.MAPPING.BOUNDARY],
        "resolution": float(cfg.MAPPING.RESOLUTION),
    }


def overlay_yaml(result: Dict) -> str:
    """The winning update window as a merge-ready yacs YAML overlay."""
    best = result["best"]
    h, w = result["image_hw"]
    lines = [
        f"# autotuned on {result['device_kind']}: {best['fps']} fps at "
        f"{h}x{w}, window {result['window']}, "
        f"bucket {result['point_bucket']}, grid "
        f"{result['boundary']} @ {result['resolution']} m",
        "MAPPING:",
        f"  UPDATE_WINDOW: {best['update_window']}",
    ]
    return "\n".join(lines) + "\n"


def write_overlay(result: Dict, path: str) -> str:
    with open(path, "w") as f:
        f.write(overlay_yaml(result))
    return path
