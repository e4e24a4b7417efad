"""3D plane: ax + by + cz + d = 0.

Port of ``vision_semantic_segmentation_tpu/geometry/plane.py`` (ref
plane_3d.py:18-160): a frozen dataclass of python floats, normalised to a
unit normal with c >= 0, whose queries take tensors and answer in their
dtype, on their device.  The constructors from points are host numpy f64.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Plane3D:
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    d: float = 0.0

    def __post_init__(self):
        s = math.sqrt(self.a**2 + self.b**2 + self.c**2)
        if s == 0:
            raise ValueError("Degenerate plane: a = b = c = 0")
        if self.c < 0:
            s = -s
        object.__setattr__(self, "a", self.a / s)
        object.__setattr__(self, "b", self.b / s)
        object.__setattr__(self, "c", self.c / s)
        object.__setattr__(self, "d", self.d / s)

    @property
    def normal(self) -> np.ndarray:
        return np.array([[self.a], [self.b], [self.c]])

    @property
    def param(self) -> np.ndarray:
        return np.array([[self.a], [self.b], [self.c], [self.d]])

    def _n(self, like: torch.Tensor) -> torch.Tensor:
        """The unit normal (3,) in ``like``'s dtype, on its device."""
        return torch.tensor([self.a, self.b, self.c], dtype=like.dtype, device=like.device)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_list(cls, p) -> "Plane3D":
        return cls(float(p[0]), float(p[1]), float(p[2]), float(p[3]))

    @classmethod
    def fit_minimal(cls, pts: np.ndarray) -> "Plane3D":
        """Exact plane through 3 points (rows), ref plane_3d.py:45-54."""
        pts = np.asarray(pts, dtype=np.float64)
        if pts.shape != (3, 3):
            raise ValueError(f"a minimal fit needs exactly 3 points, got shape {pts.shape}")
        n = np.cross(pts[0] - pts[1], pts[2] - pts[1])
        if np.allclose(n, 0):
            raise ValueError("Collinear points, plane underdetermined")
        return cls(float(n[0]), float(n[1]), float(n[2]), -float(n @ pts[1]))

    @classmethod
    def from_vectors_and_point(cls, vec1, vec2, pt1) -> "Plane3D":
        """Plane containing pt1 spanned by vec1/vec2 (ref plane_3d.py:32-42)."""
        vec1 = np.asarray(vec1, dtype=np.float64).reshape(3)
        vec2 = np.asarray(vec2, dtype=np.float64).reshape(3)
        pt1 = np.asarray(pt1, dtype=np.float64).reshape(3)
        pt2 = vec1 / np.linalg.norm(vec1) + pt1
        pt3 = vec2 / np.linalg.norm(vec2) + pt1
        return cls.fit_minimal(np.vstack([pt1, pt2, pt3]))

    # -- queries --------------------------------------------------------------
    def distance(self, points: torch.Tensor) -> torch.Tensor:
        """Unsigned distances for (N, 3) points (ref plane_3d.py:82-88)."""
        return torch.abs(self.distance_signed(points))

    def distance_signed(self, points: torch.Tensor) -> torch.Tensor:
        """Signed distances for (N, 3) points (ref plane_3d.py:90-96)."""
        points = torch.as_tensor(points)
        return points @ self._n(points) + self.d

    def ray_intersection(self, d: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
        """Intersect rays ``d`` (3, N) from the common origin ``C`` (3, 1)
        with the plane -> (3, N) points (ref plane_3d.py:150-154)."""
        n = self._n(d)[None]
        k = (-self.d - (n @ C)[0, 0]) / (n @ d)
        return k * d + C

    def normal_angle_to_vector(self, vector: torch.Tensor) -> torch.Tensor:
        """Angle between the plane normal and a vector (ref plane_3d.py:118-129)."""
        v = torch.as_tensor(vector).reshape(3)
        v = v / torch.linalg.norm(v)
        return torch.arccos(torch.clamp(v @ self._n(v), -1.0, 1.0))

    def rotated_around_y(self, angle: float) -> "Plane3D":
        """New plane with the normal pitched around y (ref plane_3d.py:109-116)."""
        norm = math.sqrt(self.a**2 + self.c**2)
        theta = math.atan2(self.c, self.a) + angle
        return Plane3D(math.cos(theta) * norm, self.b, math.sin(theta) * norm, self.d)


def ground_plane() -> Plane3D:
    """z = 0 ground plane."""
    return Plane3D(0.0, 0.0, 1.0, 0.0)


def clip_pcd_by_distance_plane(points: torch.Tensor, vec1, vec2, pt1, threshold):
    """Split a point cloud by signed distance to a plane (ref utils.py:35-53).

    The plane contains ``pt1`` and is spanned by ``vec1``/``vec2``;
    ``threshold`` is ``(max, min)`` signed distance.  Points are row-major
    (N, 3+): extra columns (intensity, ...) ride along.

    Returns:
        (close, far): points with max > distance > min, and the rest.
    """
    points = torch.as_tensor(points)
    plane = Plane3D.from_vectors_and_point(vec1, vec2, pt1)
    d = plane.distance_signed(points[:, :3])
    close = (d < threshold[0]) & (d > threshold[1])
    return points[close], points[~close]
