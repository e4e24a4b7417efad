from .camera import Camera, camera_setup_1, camera_setup_6
from .transforms import (
    euler_matrix,
    homogenize,
    mm,
    pose_to_matrix,
    quaternion_matrix,
    se3_inverse,
)

__all__ = [
    "Camera",
    "camera_setup_1",
    "camera_setup_6",
    "euler_matrix",
    "homogenize",
    "mm",
    "pose_to_matrix",
    "quaternion_matrix",
    "se3_inverse",
]
