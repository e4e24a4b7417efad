"""Projective / SE(3) transform primitives.

Port of ``vision_semantic_segmentation_tpu/geometry/transforms.py``.  Points
are column stacks (D, N), as in the reference's math (ref utils.py:68-177,
222-227, utils_ros.py:104-127).  Tensor functions keep their input's dtype
and device; the SVD-based helpers (``parameterize_rotation``,
``singularity_normalization``, ``right_null``) and ``euler_matrix`` are host
numpy in f64, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32-exact matmul.

    Geometry needs full f32: a 0.4% error is many pixels.  On the card this
    holds while TF32 matmuls are off, which ``device.resolve_device`` sets
    (the JAX package asks for ``Precision.HIGHEST`` instead).
    """
    return torch.matmul(a, b)


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero, like the JAX package's ``astype``.

    XLA's conversion saturates and maps NaN to 0, where a C cast is
    undefined out of range; clamping to +-1e9 keeps every in-range value
    and keeps out-of-image values out of the image.
    """
    return torch.nan_to_num(v, nan=0.0).clamp(-1e9, 1e9).to(torch.int32)


def homogenize(x: torch.Tensor) -> torch.Tensor:
    """(D, N) -> (D+1, N) by appending a row of ones (ref utils.py:68-70)."""
    return torch.cat([x, torch.ones((1, x.shape[1]), dtype=x.dtype, device=x.device)], dim=0)


def dehomogenize(x: torch.Tensor) -> torch.Tensor:
    """(D+1, N) -> (D, N) by dividing by the last row (ref utils.py:73-75)."""
    return x[:-1] / x[-1]


def skew(w: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix (ref utils.py:100-108)."""
    w = torch.as_tensor(w).reshape(3)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([
        torch.stack([zero, -w[2], w[1]]),
        torch.stack([w[2], zero, -w[0]]),
        torch.stack([-w[1], w[0], zero]),
    ])


def de_skew(w_skew: torch.Tensor) -> torch.Tensor:
    """3x3 skew-symmetric matrix -> (3, 1) vector (ref utils.py:111-113)."""
    return torch.stack([-w_skew[1, 2], w_skew[0, 2], -w_skew[0, 1]]).reshape(3, 1)


def sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x with sinc(0) = 1 (unnormalized; ref utils.py:82-90)."""
    x = torch.as_tensor(x)
    return torch.sinc(x / torch.pi)


def deparameterize_rotation(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix via Rodrigues (ref utils.py:150-162)."""
    w = torch.as_tensor(w).reshape(3, 1)
    theta = torch.linalg.norm(w)
    w_skew = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    # Taylor-safe coefficients: sinc(theta) and (1-cos)/theta^2
    small = theta < 1e-7
    one = torch.ones((), dtype=w.dtype, device=w.device)
    k1 = torch.where(small, one, sinc(theta))
    theta_sq = torch.where(small, one, theta**2)
    k2 = torch.where(small, 0.5 * one, (1.0 - torch.cos(theta)) / theta_sq)
    R_general = torch.cos(theta) * eye + k1 * w_skew + k2 * mm(w, w.T)
    return torch.where(small, eye + w_skew, R_general)


def parameterize_rotation(R: np.ndarray) -> Tuple[np.ndarray, float]:
    """Rotation matrix -> (axis-angle (3, 1), angle); host numpy, SVD.

    Ref utils.py:124-147, with the singularity normalization at theta = pi
    and the small-angle fallback.
    """
    R = np.asarray(R, dtype=np.float64)
    _, _, VT = np.linalg.svd(R - np.eye(3))
    v = VT.T[:, -1:]
    v_hat = np.array([[R[2, 1] - R[1, 2]], [R[0, 2] - R[2, 0]], [R[1, 0] - R[0, 1]]])
    theta_sin = float((v.T @ v_hat).item()) / 2.0
    theta_cos = (np.trace(R) - 1.0) / 2.0
    theta = float(np.arctan2(theta_sin, theta_cos))
    w = singularity_normalization(theta * v / np.linalg.norm(v))
    theta = np.linalg.norm(w)
    if theta < 1e-7:
        w = v_hat / 2.0
        theta = np.linalg.norm(w)
    return w, float(theta)


def rotation_2d(angle) -> torch.Tensor:
    """2D rotation matrix (ref utils.py:222-227)."""
    angle = torch.as_tensor(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def differentiate_sinc(x) -> torch.Tensor:
    """d/dx sinc(x), with the removable singularity at 0 (ref utils.py:93-97)."""
    x = torch.as_tensor(x)
    zero = x == 0
    safe = torch.where(zero, torch.ones_like(x), x)
    return torch.where(zero, torch.zeros_like(x), torch.cos(safe) / safe - torch.sin(safe) / safe**2)


def singularity_normalization(w: np.ndarray) -> np.ndarray:
    """Wrap an axis-angle vector into |w| <= pi (ref utils.py:116-121); host numpy."""
    w = np.asarray(w, dtype=np.float64)
    theta = np.linalg.norm(w)
    if theta > np.pi:
        w = (1 - 2 * np.pi / theta * np.ceil((theta - np.pi) / (2 * np.pi))) * w
    return w


def jacobian_vector_norm(v: torch.Tensor) -> torch.Tensor:
    """d|v|/dv as a row vector, for a column vector v (ref utils.py:165-168)."""
    v = torch.as_tensor(v)
    if v.ndim != 2 or v.shape[1] != 1:
        raise ValueError(f"column vector expected, got shape {tuple(v.shape)}")
    return v.T / torch.linalg.norm(v)


def right_null(A: np.ndarray, tol: float = 1e-5) -> Optional[np.ndarray]:
    """Right null-space vector of A, or None when it does not exist (ref
    utils.py:171-177); host numpy SVD."""
    A = np.asarray(A, dtype=np.float64)
    _, S, VT = np.linalg.svd(A)
    if S[-1] < tol:
        return VT.T[:, -1:]
    return None


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


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (3, N) points -> (3, N)."""
    return mm(T[:3, :3], points) + T[:3, 3:4]
