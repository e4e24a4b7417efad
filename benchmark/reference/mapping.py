"""Plain reference of the probabilistic BEV map update.

The semantics of the published mapping node (arXiv:2006.04894; the
reference code's ``mapping.py`` ``update_map``), written straight from
them in float64 PyTorch, independent of the measured program:

    pose -> T_origin_to_velodyne -> camera projection (plumb-bob forward
    model on the points when the label image is the raw, distorted frame)
    -> truncate to a pixel -> visible if in front, within range and inside
    the image -> the label at the pixel (nearest-downscaled when the label
    image is smaller) -> its map channel -> the point's grid cell ->
    one observation per (cell, class) a frame -> grid[:, cell] += E[:, class]
    -> +2 on the lane channel, once per cell a frame, where a lane point's
    LiDAR intensity is below 2 or above 14.

``E`` is the evidence matrix: the row-normalised log confusion submatrix
when one is configured, else the identity (one count per observation).

The calibrations below are the published vehicle's (``camera.py`` of the
reference code), copied as data.  ``dtype`` is the arithmetic's type: the
reference runs float64; the control runs the same steps in bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

# the point-cloud map's origin offset (reference ``mapping.py``)
ORIGIN_OFFSET = (1369.0496826171875, 562.84814453125)

CAMERAS = {
    "camera1": {
        "K": [[1826.998004, 0.0, 1174.548672], [0.0, 1802.603136, 776.028597], [0.0, 0.0, 1.0]],
        "Rt": [[1.5426360183850896e-01, -6.8597082105982421e-02, 9.8564556584725482e-01,
                4.7539938241243362e-02],
               [-9.8802970661938061e-01, -1.0912135033489312e-02, 1.5387730224640517e-01,
                3.1389930844306946e-01],
               [1.9996357324159053e-04, -9.9758476614047986e-01, -6.9459300162133530e-02,
                -5.5608768016099930e-02]],
        "dist": [-0.136981, 0.043159, 0.006235, 0.018954, 0.0],
        "size": (1440, 1920),
    },
    "camera6": {
        "K": [[1790.634474, 0.0, 973.099292], [0.0, 1785.950534, 803.294457], [0.0, 0.0, 1.0]],
        "Rt": [[-2.1022535018250471e-01, -9.2112145235168197e-02, 9.7330398891652492e-01,
                -1.4076865278184414e-02],
               [-9.7735897207277012e-01, -4.6117027185500481e-03, -2.1153763709301088e-01,
                -3.1732881069183350e-01],
               [2.3973774202277975e-02, -9.9573795995643932e-01, -8.9057134763516621e-02,
                -7.2184838354587555e-02]],
        "dist": [-0.191070, 0.100324, 0.004250, -0.003317, 0.0],
        "size": (1440, 1920),
    },
}


def velodyne_to_baselink() -> np.ndarray:
    """The vehicle's velodyne -> base_link extrinsic: pitch 0.140 rad about
    y, translation (2.64, 0, 1.98) m."""
    c, s = math.cos(0.140), math.sin(0.140)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = [2.64, 0.0, 1.98]
    return T


def pose_matrix(position, quaternion_xyzw) -> np.ndarray:
    """base_link -> origin of a ROS pose, float64 on the host."""
    x, y, z, w = (float(v) for v in quaternion_xyzw)
    n = math.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = np.asarray(position, dtype=np.float64).reshape(3)
    return T


class MapReference:
    """One grid and its update, for one map configuration (``map`` object
    of a configuration file)."""

    def __init__(self, map_cfg: dict, device, dtype: torch.dtype = torch.float64,
                 evidence: Optional[np.ndarray] = None):
        self.cfg = map_cfg
        self.device = torch.device(device)
        self.dtype = dtype
        (bx0, bx1), (by0, by1) = map_cfg["boundary"]
        res = float(map_cfg["resolution"])
        self.h, self.w = int((bx1 - bx0) / res), int((by1 - by0) / res)
        self.c = len(map_cfg["labels"])
        self.bmin = (bx0, by0)
        self.res = res
        self.lane = map_cfg["label_names"].index("lane") if "lane" in map_cfg["label_names"] else -1
        e = np.eye(self.c) if evidence is None else np.asarray(evidence, dtype=np.float64)
        self.evidence = torch.as_tensor(e, dtype=torch.float64, device=self.device)
        # network class -> map channel, -1 where unmapped
        table = torch.full((map_cfg["num_network_classes"],), -1, dtype=torch.long)
        for ch, net_cls in enumerate(map_cfg["labels"]):
            table[net_cls] = ch
        self.table = table.to(self.device)
        self.grid = torch.zeros((self.c, self.h * self.w), dtype=torch.float64, device=self.device)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    def channels_of_classes(self, labels: torch.Tensor) -> torch.Tensor:
        return self.table[labels.long().clamp(0, self.table.shape[0] - 1)]

    def update(self, pcd, valid, position, quaternion, channels: torch.Tensor,
               camera: str = "camera1", distorted: bool = True, full_hw=None) -> None:
        """Fuse one frame.  ``pcd`` (4, N) x, y, z, intensity in the origin
        frame; ``valid`` (N,); ``channels`` the label image as map channels
        (-1 unmapped), at the raw frame's size ``full_hw`` (default the
        camera's) or smaller."""
        cam = CAMERAS[camera]
        dt = self.dtype
        pcd = torch.as_tensor(pcd, device=self.device)
        xyz = pcd[:3].to(dt)
        T = pose_matrix(position, quaternion) @ velodyne_to_baselink()
        T_o2v = np.linalg.inv(T)
        xyz_v = self._t(T_o2v[:3, :3]) @ xyz + self._t(T_o2v[:3, 3:4])
        Rt = np.asarray(cam["Rt"], dtype=np.float64)
        R = Rt[:3, :3].T
        t = -R @ Rt[:3, 3:4]
        K = self._t(cam["K"])
        cam_pts = self._t(R) @ xyz_v + self._t(t)
        z = torch.where(cam_pts[2] == 0, torch.full_like(cam_pts[2], 1e-9), cam_pts[2])
        x, y = cam_pts[0] / z, cam_pts[1] / z
        if distorted:
            k1, k2, p1, p2, k3 = cam["dist"]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            x, y = (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                    y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        u = (K[0, 0] * x + K[0, 1] * y + K[0, 2]).clamp(-1e6, 1e6)
        v = (K[1, 1] * y + K[1, 2]).clamp(-1e6, 1e6)
        u = torch.nan_to_num(u.double(), nan=0.0).trunc().long()
        v = torch.nan_to_num(v.double(), nan=0.0).trunc().long()
        full_h, full_w = full_hw or cam["size"]
        vis = (torch.as_tensor(valid, device=self.device).bool()
               & (xyz_v[0] > 0) & (xyz_v[0] < float(self.cfg["range_max"]))
               & (u >= 0) & (u < full_w) & (v >= 0) & (v < full_h))
        lh, lw = channels.shape[:2]
        gx = u.clamp(0, full_w - 1) * lw // full_w
        gy = v.clamp(0, full_h - 1) * lh // full_h
        cls = channels.to(self.device)[gy, gx].long()
        # the map cell, in the arithmetic's own type
        row = ((xyz[0] + ORIGIN_OFFSET[0] - self.bmin[0]) / self.res).double().trunc().long()
        col = ((xyz[1] + ORIGIN_OFFSET[1] - self.bmin[1]) / self.res).double().trunc().long()
        on_grid = (row >= 0) & (row < self.h) & (col >= 0) & (col < self.w)
        upd = vis & on_grid & (cls >= 0)
        cell = (row * self.w + col)[upd]
        hit_cls = cls[upd]
        keys = torch.unique(hit_cls * (self.h * self.w) + cell)
        k_cls, k_cell = keys // (self.h * self.w), keys % (self.h * self.w)
        self.grid.index_add_(1, k_cell, self.evidence[:, k_cls])
        if self.lane >= 0 and self.cfg.get("use_intensity", True):
            inten = pcd[3].double()
            boost = upd & (cls == self.lane) & ((inten < 2) | (inten > 14))
            cells = torch.unique((row * self.w + col)[boost])
            self.grid[self.lane].index_add_(0, cells, torch.full(cells.shape, 2.0,
                                                                 dtype=torch.float64,
                                                                 device=self.device))

    def as_planar(self) -> torch.Tensor:
        return self.grid.view(self.c, self.h, self.w)


def grid_error(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Sum of |program - reference| over the sum of |reference|: the share
    of the map's evidence that differs (0 where equal)."""
    p = program.to(torch.float64).reshape(reference.shape)
    den = float(reference.abs().sum())
    return float((p - reference).abs().sum()) / max(den, 1e-30)


def per_channel(grid: torch.Tensor) -> Dict[str, float]:
    return {f"c{i}": float(grid[i].sum()) for i in range(grid.shape[0])}
