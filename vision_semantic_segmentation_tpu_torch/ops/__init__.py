from .colormap import apply_color_map, colors_to_labels
from .filters import apply_filter, box_filter_3x3
from .resize import resize_align_corners, resize_area, resize_nearest

__all__ = [
    "apply_color_map",
    "colors_to_labels",
    "apply_filter",
    "box_filter_3x3",
    "resize_align_corners",
    "resize_area",
    "resize_nearest",
]
