from .camera import Camera, camera_from_extrinsic, camera_setup_1, camera_setup_6, get_camera
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
    "camera_from_extrinsic",
    "camera_setup_1",
    "camera_setup_6",
    "get_camera",
    "euler_matrix",
    "homogenize",
    "mm",
    "pose_to_matrix",
    "quaternion_matrix",
    "se3_inverse",
]
