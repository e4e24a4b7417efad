from .file_io import makedirs
from .logger import MyLogger
from .ros_compat import TransformTree, create_point_cloud, pack_rgba, unpack_rgba

__all__ = [
    "MyLogger",
    "makedirs",
    "TransformTree",
    "create_point_cloud",
    "pack_rgba",
    "unpack_rgba",
]
