"""Stage-level profiler of the fused pipeline (the ``profile`` command).

Port of ``vision_semantic_segmentation_tpu/runtime/profiling.py``.  The
reference's only timing surface is the ``model_timer`` decorator on the
video demo's forward (ref core/utils/benchmark.py:17-25,
video_generator.py:126-128).  This module times, at the user's
configuration on the chosen device:

  * NULL: one read of one pixel of each frame (a one-element device op a
    frame), subtracted from the stages below;
  * forward: ``FusedFramePipeline.segment`` and the argmax, a frame at a
    time (on the card the ASPP runs K4);
  * e2e: ``FusedFramePipeline.run_window`` over each window, the grid
    threaded through (forward, projection, label gather and the grid
    update; on the card K4 and K2; ``tuning.time_fused_runner``),

and derives the fusion cost as e2e - forward.

The NULL stage differs from the JAX package's by design.  There a window
is one dispatch of a ``lax.scan``, and NULL is that dispatch's round trip
shared by the window's frames.  The port runs eagerly: a frame is hundreds
of launches, whose host cost is part of the forward and e2e times and is
not corrected for; NULL here is only the cost of touching each frame once,
and no other correction is made.

Timing: host clock, frames made on the device (``tuning.generate_windows``),
the first window of each stage run once untimed, then every window in
turn, best of ``repeats``, with ``torch.cuda.synchronize()`` before and
after each timed pass and one small readback at its end (the port's
counterpart of the JAX package's host-readback barrier).  No CUDA events
are used inside the stages.  A stage thus runs ``window * (1 + repeats *
n_windows)`` frames.

    python -m vision_semantic_segmentation_tpu_torch profile --cfg exp.yaml
"""
from __future__ import annotations

import time
from typing import Callable, List, Mapping, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..mapping.engine import SemanticMappingEngine
from ..models.convert import flax_to_state_dict
from .pipeline import FusedFramePipeline
from .tuning import (_resolve_distortion, generate_windows, init_state_dict, sync,
                     time_fused_runner)

__all__ = ["profile_stages", "format_report"]


def _stage_ms(run_window: Callable, windows: List[dict], window: int, repeats: int,
              device: torch.device) -> Tuple[float, float]:
    """``(best ms per frame, warm-up s)`` of ``run_window(frames, acc) ->
    acc`` (a 0-d tensor threaded through every window and read back)."""
    acc = torch.zeros((), device=device)
    sync(device)
    t0 = time.perf_counter()
    float(run_window(windows[0], acc))
    warmup_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, repeats)):
        sync(device)
        start = time.perf_counter()
        for frames in windows:
            acc = run_window(frames, acc)
        sync(device)
        float(acc)  # readback barrier
        best = min(best, time.perf_counter() - start)
    return best / (window * len(windows)) * 1e3, warmup_s


def profile_stages(
    cfg,
    variables=None,
    image_hw: Tuple[int, int] = (1440, 1920),
    window: int = 16,
    n_windows: int = 2,
    repeats: int = 3,
    camera: str = "camera1",
    distortion: str = "auto",
    confidence_weighting: bool = False,
    log=None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    device: DeviceLike = "cuda",
) -> dict:
    """Time the pipeline's stages at ``cfg``'s shapes on ``device``.

    Returns the JAX package's dict: raw and NULL-corrected ms per frame of
    each stage, the derived fusion cost and the end-to-end frames/s.
    ``distortion='auto'`` takes ``'points'`` iff the cfg asks for
    undistortion and the timed size matches the camera's calibration.  The
    weights: ``state_dict``, else ``variables`` (the JAX package's flax
    variables), else :func:`tuning.init_state_dict`; timing does not depend
    on their values, but the scatter's work does on the labels they give.
    """
    if window < 1 or n_windows < 1:
        raise ValueError(
            f"window and n_windows must be >= 1 (got window={window}, "
            f"n_windows={n_windows})"
        )
    dev = resolve_device(device)
    net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    if state_dict is None:
        state_dict = (flax_to_state_dict(variables) if variables is not None
                      else init_state_dict(net_cfg, device=dev))
    engine = SemanticMappingEngine(cfg, device=dev)
    dist = _resolve_distortion(cfg, engine, camera, image_hw, distortion)
    pipeline = FusedFramePipeline(cfg, state_dict, engine=engine, distortion=dist,
                                  confidence_weighting=confidence_weighting, device=dev)
    windows = generate_windows(cfg, image_hw, window, n_windows, device=dev)

    def null_window(frames, acc):
        for i in range(window):
            acc = acc + frames["image"][i, 0, 0, 0].float() * 0.0
        return acc

    null_ms, _ = _stage_ms(null_window, windows, window, repeats, dev)
    if log:
        log(f"{'NULL (one-pixel read/frame)':38s} {null_ms:8.2f} ms")

    def forward_window(frames, acc):
        for i in range(window):
            logits = pipeline.segment(frames["image"][i], camera)
            acc = acc + torch.argmax(logits, dim=1).reshape(-1)[0].float()
        return acc

    fwd_raw, _ = _stage_ms(forward_window, windows, window, repeats, dev)
    fwd_ms = max(fwd_raw - null_ms, 0.0)
    if log:
        log(f"{'forward (seg prologue + argmax)':38s} {fwd_ms:8.2f} ms  (raw {fwd_raw:.2f})")

    fps, warmup_s = time_fused_runner(pipeline, windows, window, camera, repeats)
    e2e_raw = 1000.0 / fps
    e2e_ms = max(e2e_raw - null_ms, 0.0)
    fusion_ms = max(e2e_ms - fwd_ms, 0.0)
    if log:
        log(f"{'e2e fused step':38s} {e2e_ms:8.2f} ms  (raw {e2e_raw:.2f})")
        log(f"{'fusion (e2e - forward, derived)':38s} {fusion_ms:8.2f} ms")
        log(f"{'throughput':38s} {fps:8.2f} fps  (warmup {warmup_s:.0f}s)")

    return {
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "image_hw": list(image_hw),
        "window": window,
        "n_windows": n_windows,
        "repeats": repeats,
        "camera": camera,
        "distortion": dist,
        "confidence_weighting": bool(confidence_weighting),
        "boundary": [list(b) for b in cfg.MAPPING.BOUNDARY],
        "resolution": float(cfg.MAPPING.RESOLUTION),
        "point_bucket": int(cfg.MAPPING.POINT_BUCKET),
        "null_ms": round(null_ms, 3),
        "forward_ms": round(fwd_ms, 3),
        "forward_ms_raw": round(fwd_raw, 3),
        "e2e_ms": round(e2e_ms, 3),
        "e2e_ms_raw": round(e2e_raw, 3),
        "fusion_ms": round(fusion_ms, 3),
        "e2e_fps": round(fps, 3),
        "warmup_s": round(warmup_s, 1),
    }


def format_report(result: dict) -> str:
    """One-paragraph human summary of a :func:`profile_stages` result."""
    h, w = result["image_hw"]
    return (
        f"{result['device_kind']} @ {h}x{w} (distortion={result['distortion']}, "
        f"window {result['window']}): forward {result['forward_ms']:.2f} ms, "
        f"fusion {result['fusion_ms']:.2f} ms, e2e {result['e2e_ms_raw']:.2f} "
        f"ms/frame = {result['e2e_fps']:.2f} fps "
        f"(dispatch overhead {result['null_ms']:.2f} ms/frame, "
        f"warmup {result['warmup_s']:.0f}s)"
    )
