"""ROS-free equivalents of the reference's ROS glue.

Port of ``vision_semantic_segmentation_tpu/utils/ros_compat.py`` (ref
src/utils/utils_ros.py:31-123, without rospy):
  * :func:`create_point_cloud` — labelled point clouds as a structured
    numpy array with the field layout of the PointCloud2 message
    (x, y, z float32 + packed rgba uint32);
  * :class:`TransformTree` — a minimal TF buffer: register stamped rigid
    transforms between named frames and compose lookups through their
    common root (the subset of tf the pipeline uses).

Host numpy throughout, in float64 (the quaternion matrix comes from the
port's ``geometry/transforms.py`` on a float64 CPU tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.transforms import pose_to_matrix, quaternion_matrix


def pack_rgba(rgb: np.ndarray, alpha: int = 255) -> np.ndarray:
    """(N, 3) uint8 colours -> (N,) packed little-endian RGBA uint32
    (ref utils_ros.py:50-52: bytes B,B,B,255 unpacked as one 'I')."""
    rgb = np.asarray(rgb, dtype=np.uint32)
    a = np.uint32(alpha)
    return rgb[:, 0] | (rgb[:, 1] << 8) | (rgb[:, 2] << 16) | (a << 24)


def unpack_rgba(packed: np.ndarray) -> np.ndarray:
    """(N,) packed uint32 -> (N, 4) uint8 r, g, b, a."""
    packed = np.asarray(packed, dtype=np.uint32)
    return np.stack(
        [packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF, (packed >> 24) & 0xFF],
        axis=1,
    ).astype(np.uint8)


def create_point_cloud(
    xyz: np.ndarray, rgb: Optional[np.ndarray] = None, frame_id: str = "world"
) -> Dict[str, object]:
    """A PointCloud2-shaped record (ref utils_ros.py:31-59): 'frame_id',
    'fields' and a structured 'data' array."""
    xyz = np.asarray(xyz, dtype=np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz must be (N, 3), got {xyz.shape}")
    fields = ["x", "y", "z"] + ([] if rgb is None else ["rgba"])
    dtype = np.dtype([(f, "<f4") for f in ("x", "y", "z")]
                     + ([] if rgb is None else [("rgba", "<u4")]))
    data = np.empty(xyz.shape[0], dtype=dtype)
    data["x"], data["y"], data["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    if rgb is not None:
        data["rgba"] = pack_rgba(np.asarray(rgb)[:, :3])
    return {"frame_id": frame_id, "fields": fields, "data": data}


@dataclasses.dataclass
class StampedTransform:
    parent: str
    child: str
    T: np.ndarray  # parent_from_child
    stamp: float = 0.0


class TransformTree:
    """Tiny TF buffer: frame graph of rigid transforms with composition.

    Covers the reference's usage: ``set_map_pose`` broadcasts a transform
    (ref utils_ros.py:62-75), ``get_transformation`` looks one up and
    composes (ref :77-102).
    """

    def __init__(self):
        self._edges: Dict[str, StampedTransform] = {}  # child -> edge

    def set_transform(self, parent: str, child: str, T: np.ndarray, stamp: float = 0.0):
        self._edges[child] = StampedTransform(parent, child, np.asarray(T, float), stamp)

    def set_pose(self, pose_position, pose_quaternion, parent: str, child: str,
                 stamp: float = 0.0):
        """ROS-pose flavoured setter (the set_map_pose shape)."""
        T = pose_to_matrix(torch.as_tensor(np.asarray(pose_position, np.float64)),
                           torch.as_tensor(np.asarray(pose_quaternion, np.float64)))
        self.set_transform(parent, child, T.numpy(), stamp)

    def _path_to_root(self, frame: str):
        path = []
        while frame in self._edges:
            edge = self._edges[frame]
            path.append(edge)
            frame = edge.parent
        return frame, path

    def lookup(self, frame_to: str, frame_from: str) -> np.ndarray:
        """T such that p_to = T @ p_from (tf lookupTransform order)."""
        root_a, path_a = self._path_to_root(frame_from)
        root_b, path_b = self._path_to_root(frame_to)
        if root_a != root_b:
            raise LookupError(f"frames {frame_from!r} and {frame_to!r} are not connected")
        T_root_from = np.eye(4)
        for edge in reversed(path_a):
            T_root_from = T_root_from @ edge.T
        T_root_to = np.eye(4)
        for edge in reversed(path_b):
            T_root_to = T_root_to @ edge.T
        R, t = T_root_to[:3, :3], T_root_to[:3, 3:4]
        T_to_root = np.eye(4)
        T_to_root[:3, :3] = R.T
        T_to_root[:3, 3:4] = -R.T @ t
        return T_to_root @ T_root_from

    def get_transformation(self, frame_from: str, frame_to: str):
        """(T, translation) lookup mirroring ref :77-102; (None, None) when
        the frames are not connected."""
        try:
            T = self.lookup(frame_to, frame_from)
        except LookupError:
            return None, None
        return T, T[:3, 3].copy()


def get_normal_from_pose(position, quaternion_xyzw) -> np.ndarray:
    """Unit z-axis of a pose's orientation, as a (3, 1) normal (ref
    utils_ros.py:113-123: the rotation matrix's third column)."""
    T = quaternion_matrix(torch.as_tensor(np.asarray(quaternion_xyzw, np.float64)))
    return T.numpy()[0:3, 2:3]
