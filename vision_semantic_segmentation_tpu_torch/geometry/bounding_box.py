"""2D bounding box (ref bounding_box.py:1-48).

Copy of ``vision_semantic_segmentation_tpu/geometry/bounding_box.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BoundingBox:
    """left/top/width/height box in image coordinates."""

    left: float
    top: float
    width: float
    height: float
    cls: str = ""
    score: float = 1.0

    @property
    def right(self) -> float:
        return self.left + self.width

    @property
    def bottom(self) -> float:
        return self.top + self.height

    def bottom_point(self) -> Tuple[float, float]:
        """Bottom-center point, used for ground ray casting (ref :24)."""
        return (self.left + self.width / 2.0, self.top + self.height)

    def center(self) -> Tuple[float, float]:
        return (self.left + self.width / 2.0, self.top + self.height / 2.0)
