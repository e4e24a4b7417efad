from .confusion import ConfusionMatrix, evidence_matrix
from .engine import (
    GridSpec,
    PCD_ORIGIN_OFFSET,
    SemanticMappingEngine,
    pad_points,
    velodyne_to_baselink,
)
from .renderer import LABEL_COLORS, apply_filter, render_bev_map

__all__ = [
    "ConfusionMatrix",
    "evidence_matrix",
    "GridSpec",
    "PCD_ORIGIN_OFFSET",
    "SemanticMappingEngine",
    "pad_points",
    "velodyne_to_baselink",
    "LABEL_COLORS",
    "apply_filter",
    "render_bev_map",
]
