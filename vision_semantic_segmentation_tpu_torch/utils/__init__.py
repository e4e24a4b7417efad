from .file_io import makedirs
from .logger import MyLogger
from .markers import Marker, hull_markers, visualize_marker
from .ros_compat import TransformTree, create_point_cloud, pack_rgba, unpack_rgba

__all__ = [
    "MyLogger",
    "Marker",
    "hull_markers",
    "visualize_marker",
    "makedirs",
    "TransformTree",
    "create_point_cloud",
    "pack_rgba",
    "unpack_rgba",
]
