"""Projective camera model.

Port of ``vision_semantic_segmentation_tpu/geometry/camera.py``: a frozen
calibration container with host-numpy P, P_norm, T, K_inv and C_world;
projection and ray casting on tensors (f32 for the hull markers, as in the
JAX package); the plumb-bob forward model on tensors; and the host-side
inverse map for image undistortion.  The two vehicle cameras' calibrations
(ref camera.py:102-135) are the same numbers, and ``camera_from_extrinsic``
rebuilds one from TF extrinsics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .transforms import dehomogenize, homogenize, mm


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with plumb-bob distortion (ref camera.py:22-35).

      K       3x3 intrinsics
      R, t    world->camera rotation / translation
      P       3x4 projection  K [R|t]
      T       4x4 extrinsic homogeneous transform
      C       3x1 camera center in world frame (-R^T t)
      im_size (width, height)
      dist    plumb-bob coefficients (k1, k2, p1, p2, k3)
    """

    K: np.ndarray
    R: np.ndarray
    t: np.ndarray
    im_size: Optional[Tuple[int, int]] = None
    id: int = 0
    dist: Optional[np.ndarray] = None

    @property
    def P_norm(self) -> np.ndarray:
        return np.concatenate([self.R, self.t], axis=1)

    @property
    def P(self) -> np.ndarray:
        return self.K @ self.P_norm

    @property
    def T(self) -> np.ndarray:
        T = np.vstack([self.P_norm, np.zeros((1, 4))])
        T[-1, -1] = 1.0
        return T

    @property
    def K_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K)

    @property
    def C_world(self) -> np.ndarray:
        return -self.R.T @ self.t

    def _as(self, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A host calibration matrix in ``like``'s dtype, on its device."""
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def project(self, points_3d: torch.Tensor) -> torch.Tensor:
        """World points (3, N) -> image pixels (2, N) (ref camera.py:87-91)."""
        return dehomogenize(mm(self._as(self.P, points_3d), homogenize(points_3d)))

    def pixel_to_ray(self, pts: torch.Tensor, world: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pixels (2, N) -> unit ray directions (3, N) + centre (3, 1).

        Ref camera.py:58-72.  Each direction is divided by the sign of its
        first coordinate (world rays) or its third (camera rays), so that it
        points away from the camera consistently, as in the JAX package.
        """
        pts_norm = mm(self._as(self.K_inv, pts), homogenize(pts))
        if world:
            d = mm(self._as(self.R.T, pts), pts_norm)
            d = d / torch.sign(d[0:1, :]) / torch.linalg.norm(d, dim=0, keepdim=True)
            C = self._as(self.C_world, pts)
        else:
            d = pts_norm / torch.sign(pts_norm[2:3, :]) / torch.linalg.norm(
                pts_norm, dim=0, keepdim=True)
            C = torch.zeros((3, 1), dtype=d.dtype, device=d.device)
        return d, C

    def bounding_box_to_ray(self, bbox) -> Tuple[torch.Tensor, torch.Tensor]:
        """World ray through a bounding box's bottom-centre point, in f32 (ref
        camera.py:74-77)."""
        ix, iy = bbox.bottom_point()
        return self.pixel_to_ray(torch.tensor([[ix], [iy]], dtype=torch.float32), world=True)

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Apply plumb-bob distortion to normalized coords (2, N)."""
        if self.dist is None:
            return xy
        k1, k2, p1, p2, k3 = [float(v) for v in self.dist]
        x, y = xy[0], xy[1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x_d = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_d = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([x_d, y_d])

    def undistort_maps(self) -> np.ndarray:
        """The (2, H, W) f32 sampling grid for image undistortion.

        For each *undistorted* output pixel, the distorted source pixel to
        sample: the inverse map ``cv2.undistort`` builds (ref
        vision_semantic_segmentation_node.py:85-87).  Host numpy, computed
        once per camera.  The distortion polynomial runs in f32, as the JAX
        package evaluates it; the intrinsics in f64.
        """
        if self.im_size is None:
            raise ValueError("im_size required for undistortion")
        w, h = self.im_size
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        pix = np.stack([xs.ravel(), ys.ravel()])
        # normalized undistorted coords
        xy = (np.linalg.inv(self.K) @ np.vstack([pix, np.ones((1, pix.shape[1]))]))[:2]
        xy_d = self.distort_normalized(torch.from_numpy(xy.astype(np.float32))).numpy()
        src = self.K @ np.vstack([xy_d, np.ones((1, xy_d.shape[1]))])
        return (src[:2] / src[2]).reshape(2, h, w).astype(np.float32)


def camera_setup_1() -> Camera:
    """Vehicle camera 1 calibration (ref camera.py:102-117)."""
    K = np.array(
        [
            [1826.998004, 0.000000, 1174.548672],
            [0.000000, 1802.603136, 776.028597],
            [0.000000, 0.000000, 1.000000],
        ]
    )
    Rt = np.array(
        [
            [1.5426360183850896e-01, -6.8597082105982421e-02, 9.8564556584725482e-01, 4.7539938241243362e-02],
            [-9.8802970661938061e-01, -1.0912135033489312e-02, 1.5387730224640517e-01, 3.1389930844306946e-01],
            [1.9996357324159053e-04, -9.9758476614047986e-01, -6.9459300162133530e-02, -5.5608768016099930e-02],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    R = Rt[0:3, 0:3].T
    t = -R @ Rt[0:3, 3:4]
    dist = np.array([-0.136981, 0.043159, 0.006235, 0.018954, 0.000000])
    return Camera(K=K, R=R, t=t, im_size=(1920, 1440), id=1, dist=dist)


def camera_setup_6() -> Camera:
    """Vehicle camera 6 calibration (ref camera.py:120-135)."""
    K = np.array(
        [
            [1790.634474, 0.0, 973.099292],
            [0.0, 1785.950534, 803.294457],
            [0.0, 0.0, 1.0],
        ]
    )
    Rt = np.array(
        [
            [-2.1022535018250471e-01, -9.2112145235168197e-02, 9.7330398891652492e-01, -1.4076865278184414e-02],
            [-9.7735897207277012e-01, -4.6117027185500481e-03, -2.1153763709301088e-01, -3.1732881069183350e-01],
            [2.3973774202277975e-02, -9.9573795995643932e-01, -8.9057134763516621e-02, -7.2184838354587555e-02],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    R = Rt[0:3, 0:3].T
    t = -R @ Rt[0:3, 3:4]
    dist = np.array([-0.191070, 0.100324, 0.004250, -0.003317, 0.000000])
    return Camera(K=K, R=R, t=t, im_size=(1920, 1440), id=6, dist=dist)


def camera_from_extrinsic(base: Camera, T_cam_to_velodyne: np.ndarray) -> Camera:
    """Camera with ``base``'s intrinsics but TF-derived extrinsics.

    The reference resolves camera->base_link from the live TF tree at node
    startup and composes it with the pose for projection (ref
    mapping.py:142-163, get_extrinsics :528-541); this is the static half of
    that path: given camera->velodyne, rebuild P = K [R|t] with R, t mapping
    velodyne-frame points into the camera frame.
    """
    T = np.linalg.inv(np.asarray(T_cam_to_velodyne, dtype=np.float64))
    return Camera(K=base.K, R=T[:3, :3], t=T[:3, 3:4], im_size=base.im_size, id=base.id,
                  dist=base.dist)


def get_camera(frame_id: str) -> Camera:
    """Look up a vehicle camera by ROS frame id (ref mapping.py:273-278)."""
    table = {"camera1": camera_setup_1, "camera6": camera_setup_6}
    if frame_id not in table:
        raise KeyError(f"No calibration for frame_id {frame_id!r}")
    return table[frame_id]()
