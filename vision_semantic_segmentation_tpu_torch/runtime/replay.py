"""Deterministic offline replay of recorded frames.

Port of ``vision_semantic_segmentation_tpu/runtime/replay.py::MappingReplay``
(ref mapping_replay.py:146-211): fuse recorded frames into the grid through
the mapping engine, then smooth, render, save ``global_map_<name>.png`` and
score against ground truth.  ``finalize`` renders through K1
(``ops/kernels/render.py``): the kernel on a CUDA grid, its plain version
on a CPU grid.  Grid sharding and frame-parallel replay are not ported yet.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.defaults import resolve_output_dir
from ..device import DeviceLike
from ..mapping.engine import SemanticMappingEngine, pad_points
from ..ops.kernels.render import render_bev_map_fused, unpack_rgba_image
from .io import FrameRecord

log = logging.getLogger(__name__)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (stdlib only).

    The bytes are the array's channels reversed, which is what
    ``cv2.imwrite(path, array)`` stores: the JAX package hands its RGB array
    to cv2 unchanged (ref mapping.py:340), and ``cv2.imread`` of either file
    returns that array.
    """
    img = np.ascontiguousarray(np.asarray(rgb, dtype=np.uint8)[..., ::-1])
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class MappingReplay:
    """Replays recorded sequences through the mapping engine."""

    def __init__(self, cfg, engine: Optional[SemanticMappingEngine] = None,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.output_dir = resolve_output_dir(cfg.OUTPUT_DIR, cfg.TASK_NAME)
        self.engine = engine or SemanticMappingEngine(cfg, device=device)
        self.label_colors = np.array(cfg.LABEL_COLORS, dtype=np.uint8)

    def run_frames(self, frames: Sequence[FrameRecord], init_grid=None) -> torch.Tensor:
        """Fuse a frame sequence into a fresh grid (or a copy of ``init_grid``)."""
        engine = self.engine
        if init_grid is None:
            grid = engine.init_grid()
        else:
            grid = torch.as_tensor(init_grid, device=engine.device).clone()
        for f in frames:
            pcd, valid = pad_points(np.asarray(f.pcd, dtype=np.float32), engine.point_bucket)
            grid, _, _ = engine.step(
                grid, pcd, valid, f.semantic_image, f.position, f.quaternion,
                camera=f.camera, pcd_frame_id=f.pcd_frame_id,
            )
        return grid

    def finalize(self, grid: torch.Tensor, name: str = "") -> np.ndarray:
        """Smooth + render (K1) + save + evaluate (ref mapping_replay.py:194-211)."""
        packed = render_bev_map_fused(grid, self.label_colors)
        color_map = unpack_rgba_image(packed).cpu().numpy()

        os.makedirs(self.output_dir, exist_ok=True)
        suffix = f"_{name}" if name else ""
        output_file = osp.join(self.output_dir, f"global_map{suffix}.png")
        write_png(output_file, color_map)
        log.info("Saved map to %s", output_file)

        if self.cfg.GROUND_TRUTH_DIR:
            from ..evaluation.map_eval import MapEvaluator

            MapEvaluator(ground_truth_dir=self.cfg.GROUND_TRUTH_DIR).test_single_map(color_map)
        return color_map
