"""Projective camera model.

Port of ``vision_semantic_segmentation_tpu/geometry/camera.py`` (the parts
the mapping and online paths use): a frozen calibration container with
host-numpy P, K and P_norm, the plumb-bob forward model on tensors, and the
host-side inverse map for image undistortion.  The two vehicle cameras'
calibrations (ref camera.py:102-135) are the same numbers, and
``camera_from_extrinsic`` rebuilds one from TF extrinsics.  Ray casting
(``pixel_to_ray``, for the hull markers) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with plumb-bob distortion (ref camera.py:22-35).

      K       3x3 intrinsics
      R, t    world->camera rotation / translation
      P       3x4 projection  K [R|t]
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
