from .confusion import ConfusionMatrix, evidence_matrix
from .engine import (
    GridSpec,
    PCD_ORIGIN_OFFSET,
    SemanticMappingEngine,
    pad_points,
    velodyne_to_baselink,
)
from .renderer import (
    FILL_PRIORITY,
    LABEL_COLORS,
    add_car_to_map,
    apply_filter,
    fill_black,
    fill_black_mode,
    fill_edge,
    log_odds_to_probability,
    map_layer_images,
    render_bev_map,
    render_bev_map_with_thresholds,
    resume_color,
)
from .stitching import stitch_image

__all__ = [
    "ConfusionMatrix",
    "evidence_matrix",
    "GridSpec",
    "PCD_ORIGIN_OFFSET",
    "SemanticMappingEngine",
    "pad_points",
    "velodyne_to_baselink",
    "FILL_PRIORITY",
    "LABEL_COLORS",
    "add_car_to_map",
    "apply_filter",
    "fill_black",
    "fill_black_mode",
    "fill_edge",
    "log_odds_to_probability",
    "map_layer_images",
    "render_bev_map",
    "render_bev_map_with_thresholds",
    "resume_color",
    "stitch_image",
]
