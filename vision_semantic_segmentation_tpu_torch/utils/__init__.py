from .file_io import get_dir_list, get_file_list, makedirs, move, remove
from .logger import MyLogger, setup_logger
from .benchmark import profile, span, trace
from .markers import Marker, hull_markers, visualize_marker
from .seed import set_random_seed
from .ros_compat import TransformTree, create_point_cloud, pack_rgba, unpack_rgba
from .pcd_bev import generate_pointcloud_bev, pointcloud_to_bev, read_pcd

__all__ = [
    "get_dir_list",
    "get_file_list",
    "makedirs",
    "move",
    "remove",
    "MyLogger",
    "setup_logger",
    "profile",
    "span",
    "trace",
    "set_random_seed",
    "Marker",
    "hull_markers",
    "visualize_marker",
    "TransformTree",
    "create_point_cloud",
    "pack_rgba",
    "unpack_rgba",
    "generate_pointcloud_bev",
    "pointcloud_to_bev",
    "read_pcd",
]
