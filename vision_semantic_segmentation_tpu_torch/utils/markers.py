"""Visualization marker construction (ref vis.py:1-113).

Copy of ``vision_semantic_segmentation_tpu/utils/markers.py``.  ROS-free:
builds plain dataclass records with the same semantics as
``visualization_msgs/Marker`` (sphere / cube / line_strip / arrow, RGBA
color, lifetime) so a thin bridge can serialize them, and diagnostics /
tests can assert on them directly.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

_id_counter = itertools.count()

MARKER_TYPES = ("sphere", "cube", "line_strip", "arrow", "points", "text")


@dataclasses.dataclass
class Marker:
    marker_type: str
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    color: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 1.0)
    points: Optional[np.ndarray] = None  # (N, 3) for line_strip / points
    frame_id: str = "world"
    lifetime: float = 0.0  # seconds; 0 = forever
    id: int = 0
    text: str = ""


def visualize_marker(
    position,
    frame_id: str = "world",
    mtype: str = "sphere",
    scale=(1.0, 1.0, 1.0),
    color=(1.0, 0.0, 0.0, 1.0),
    points: Optional[Sequence] = None,
    lifetime: float = 0.0,
    orientation=(0.0, 0.0, 0.0, 1.0),
    text: str = "",
) -> Marker:
    """Construct a marker record (ref vis.py ``visualize_marker``)."""
    if mtype not in MARKER_TYPES:
        raise ValueError(f"Unknown marker type {mtype!r}")
    if points is not None:
        points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    return Marker(
        marker_type=mtype,
        position=tuple(float(v) for v in position),
        orientation=tuple(float(v) for v in orientation),
        scale=tuple(float(v) for v in (scale if not np.isscalar(scale) else (scale,) * 3)),
        color=tuple(float(v) for v in color),
        points=points,
        frame_id=frame_id,
        lifetime=float(lifetime),
        id=next(_id_counter),
        text=text,
    )


def hull_markers(vertex_loops: Sequence[np.ndarray], frame_id: str = "world",
                 color=(0.0, 1.0, 0.0, 1.0)) -> List[Marker]:
    """Line-strip markers for convex-hull loops (ref node:138-153 usage)."""
    markers = []
    for loop in vertex_loops:
        pts = np.vstack([loop, np.zeros((1, loop.shape[1]))]).T  # (K, 3)
        markers.append(
            visualize_marker(
                position=(0, 0, 0), frame_id=frame_id, mtype="line_strip",
                scale=(0.1, 0.1, 0.1), color=color, points=pts,
            )
        )
    return markers
