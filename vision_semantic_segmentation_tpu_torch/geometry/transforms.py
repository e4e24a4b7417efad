"""Projective / SE(3) transform primitives.

Port of the parts of ``vision_semantic_segmentation_tpu/geometry/
transforms.py`` the mapping path uses.  Points are column stacks (D, N), as
in the reference's math (ref utils.py:68-162, utils_ros.py:104-127).
"""
from __future__ import annotations

import numpy as np
import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32-exact matmul.

    Geometry needs full f32: a 0.4% error is many pixels.  On the card this
    holds while TF32 matmuls are off, which ``device.resolve_device`` sets
    (the JAX package asks for ``Precision.HIGHEST`` instead).
    """
    return torch.matmul(a, b)


def homogenize(x: torch.Tensor) -> torch.Tensor:
    """(D, N) -> (D+1, N) by appending a row of ones (ref utils.py:68-70)."""
    return torch.cat([x, torch.ones((1, x.shape[1]), dtype=x.dtype, device=x.device)], dim=0)


def euler_matrix(ai: float, aj: float, ak: float) -> np.ndarray:
    """4x4 homogeneous rotation from static-frame xyz Euler angles (host numpy).

    ``tf.transformations.euler_matrix(ai, aj, ak, 'sxyz')`` (ref
    mapping.py:167): ``Rz(ak) @ Ry(aj) @ Rx(ai)``.
    """
    ci, si = np.cos(ai), np.sin(ai)
    cj, sj = np.cos(aj), np.sin(aj)
    ck, sk = np.cos(ak), np.sin(ak)
    Rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    Ry = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
    Rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    return T


def quaternion_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> 4x4 homogeneous rotation (ROS order)."""
    q = q.reshape(4)
    n = torch.dot(q, q)
    q = q * torch.sqrt(2.0 / n)
    x, y, z, w = q[0], q[1], q[2], q[3]
    R = torch.stack(
        [
            torch.stack([1.0 - (y * y + z * z), x * y - z * w, x * z + y * w]),
            torch.stack([x * y + z * w, 1.0 - (x * x + z * z), y * z - x * w]),
            torch.stack([x * z - y * w, y * z + x * w, 1.0 - (x * x + y * y)]),
        ]
    )
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    return T


def pose_to_matrix(position: torch.Tensor, orientation_xyzw: torch.Tensor) -> torch.Tensor:
    """ROS Pose (position, quaternion) -> 4x4 ``T_base_to_origin``."""
    T = quaternion_matrix(orientation_xyzw)
    T[:3, 3] = position.reshape(3)
    return T


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid 4x4 transform."""
    R = T[:3, :3]
    t = T[:3, 3:4]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3:4] = -mm(R.T, t)
    return Ti
