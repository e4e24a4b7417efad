from .file_io import makedirs
from .logger import MyLogger, setup_logger
from .markers import Marker, hull_markers, visualize_marker
from .seed import set_random_seed
from .ros_compat import TransformTree, create_point_cloud, pack_rgba, unpack_rgba

__all__ = [
    "MyLogger",
    "setup_logger",
    "set_random_seed",
    "Marker",
    "hull_markers",
    "visualize_marker",
    "makedirs",
    "TransformTree",
    "create_point_cloud",
    "pack_rgba",
    "unpack_rgba",
]
