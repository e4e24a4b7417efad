"""Segmentation video demo.

Port of ``vision_semantic_segmentation_tpu/runtime/video.py`` (ref
src/network/deeplab_v3_plus/video_generator.py:85-241): run the network
over a video file, blend the colourised prediction with the frame, and
write an MJPG ``.avi``.  Each frame's forward, argmax, nearest resize and
colourise run on the predictor's device (on the card the ASPP runs K4);
decode, blend and encode stay on the host (cv2).
"""
from __future__ import annotations

import os.path as osp
import time
from typing import Optional, Tuple

import numpy as np

from ..device import DeviceLike
from ..inference.predictor import SemanticSegmentation, colorize_labels, postprocess_labels
from ..ops.colormap import palette_from_cfg


def generate_video(
    cfg,
    video_path: str,
    output_dir: str,
    output_name: str = "",
    predictor: Optional[SemanticSegmentation] = None,
    palette: Optional[np.ndarray] = None,
    blend: float = 0.5,
    resize_hw: Optional[Tuple[int, int]] = None,
    max_frames: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> str:
    """Segment a video and write the blended overlay (ref :85-192).

    Args:
        cfg: network demo config (builds the predictor when ``predictor``
            is None, on ``device``; picks the palette when ``palette`` is
            None, by ``TRAIN_DATASET`` / ``DATASET_CONFIG`` as the
            reference's demo does, ref video_generator.py:24-27, 96-101).
        blend: overlay opacity of the colourised prediction.
        resize_hw: optional (h, w) processing resolution.

    Prints the frames written and the model FPS (segmentation, resize and
    colourise up to the host copy); returns the output video path.
    """
    import cv2

    if predictor is None:
        predictor = SemanticSegmentation(cfg, device=device)
    if palette is None:
        palette = palette_from_cfg(cfg)

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video {video_path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 10.0

    name = output_name or osp.splitext(osp.basename(video_path))[0]
    out_path = osp.join(output_dir, f"{name}.avi")

    writer = None
    frame_count = 0
    model_time = 0.0
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            if resize_hw is not None:
                frame_bgr = cv2.resize(frame_bgr, (resize_hw[1], resize_hw[0]))
            rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)

            tic = time.perf_counter()
            labels = postprocess_labels(predictor.labels(rgb), rgb.shape[:2])
            colored = colorize_labels(labels, palette).cpu().numpy()
            model_time += time.perf_counter() - tic

            overlay = (frame_bgr * (1 - blend) + colored[..., ::-1] * blend).astype(np.uint8)
            if writer is None:
                h, w = overlay.shape[:2]
                writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
            writer.write(overlay)
            frame_count += 1
            if max_frames is not None and frame_count >= max_frames:
                break
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if frame_count:
        print(f"Wrote {frame_count} frames to {out_path} "
              f"({frame_count / max(model_time, 1e-9):.1f} model FPS)")
    return out_path
