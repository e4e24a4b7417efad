"""Deterministic replay frame IO.

The reference records every mapping input to an ``input_list.hkl`` hickle
file ({pcd, pcd_frame_id, semantic_image, pose} per frame, ref
mapping.py:309-326) and replays it bit-identically offline
(mapping_replay.py:146-211).  The native format here is ``.npz`` (one
archive per sequence, per-frame keys); reference ``.hkl`` dumps load through
:mod:`.hickle_io` (a hickle-schema reader over h5py) and pickled dumps
through the same dataclass.

Port copy of ``vision_semantic_segmentation_tpu/runtime/io.py``.
"""
from __future__ import annotations

import dataclasses
import os
import os.path as osp
import pickle
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class FrameRecord:
    """One mapping input frame (ref mapping.py:309-313)."""

    pcd: np.ndarray                # (4, N) x, y, z, intensity
    pcd_frame_id: str              # e.g. 'world' (points_map) or 'velodyne'
    semantic_image: np.ndarray     # (H, W, 3) uint8 RGB
    position: np.ndarray           # (3,) pose position
    quaternion: np.ndarray         # (4,) pose orientation x, y, z, w
    camera: str = "camera1"
    stamp: float = 0.0
    # the paired cloud's own stamp, where a stream knows it (not saved)
    pcd_stamp: Optional[float] = None


def save_frames(frames: Sequence[FrameRecord], path: str) -> None:
    """Persist a sequence as one .npz archive."""
    arrays = {"num_frames": np.asarray(len(frames))}
    meta = []
    for i, f in enumerate(frames):
        arrays[f"pcd_{i}"] = np.asarray(f.pcd, dtype=np.float32)
        arrays[f"image_{i}"] = np.asarray(f.semantic_image, dtype=np.uint8)
        arrays[f"position_{i}"] = np.asarray(f.position, dtype=np.float64)
        arrays[f"quaternion_{i}"] = np.asarray(f.quaternion, dtype=np.float64)
        meta.append((f.pcd_frame_id, f.camera, f.stamp))
    arrays["meta"] = np.asarray(meta, dtype=object)
    # NOTE: savez has no allow_pickle parameter (np.save's default already
    # permits the object 'meta' array); passing one would store a bogus
    # scalar array named 'allow_pickle' in every archive
    np.savez_compressed(path, **arrays)


def load_frames(path: str) -> List[FrameRecord]:
    """Load a sequence saved by :func:`save_frames`."""
    frames: List[FrameRecord] = []
    with np.load(path, allow_pickle=True) as data:
        n = int(data["num_frames"])
        meta = data["meta"]
        for i in range(n):
            frame_id, camera, stamp = meta[i]
            frames.append(
                FrameRecord(
                    pcd=data[f"pcd_{i}"],
                    pcd_frame_id=str(frame_id),
                    semantic_image=data[f"image_{i}"],
                    position=data[f"position_{i}"],
                    quaternion=data[f"quaternion_{i}"],
                    camera=str(camera),
                    stamp=float(stamp),
                )
            )
    return frames



def _pose_to_arrays(pose) -> Tuple[np.ndarray, np.ndarray]:
    """Extract position/quaternion from a ROS-style Pose object or dict."""
    if isinstance(pose, dict):
        p, o = pose["position"], pose["orientation"]
        if isinstance(p, dict):
            return (
                np.array([p["x"], p["y"], p["z"]]),
                np.array([o["x"], o["y"], o["z"], o["w"]]),
            )
        return np.asarray(p, dtype=np.float64), np.asarray(o, dtype=np.float64)
    if isinstance(pose, np.ndarray) and pose.shape == (7,):
        return pose[:3].astype(np.float64), pose[3:].astype(np.float64)
    if hasattr(pose, "pose"):  # PoseStamped
        pose = pose.pose
    p, o = pose.position, pose.orientation
    return np.array([p.x, p.y, p.z]), np.array([o.x, o.y, o.z, o.w])


def load_reference_dump(path: str) -> List[FrameRecord]:
    """Load a reference-format input_list (.hkl via hickle_io, or pickle).

    Accepts the reference's list-of-dicts layout (ref mapping.py:309-313).
    A ``.pkl`` is unpickled as it is: load only dumps you trust.
    """
    if path.endswith(".hkl"):
        from .hickle_io import load_hickle

        input_list = load_hickle(path)
    else:
        with open(path, "rb") as f:
            input_list = pickle.load(f)

    frames = []
    for d in input_list:
        position, quaternion = _pose_to_arrays(d["pose"])
        frames.append(
            FrameRecord(
                pcd=np.asarray(d["pcd"]),
                pcd_frame_id=str(d["pcd_frame_id"]),
                semantic_image=np.asarray(d["semantic_image"]),
                position=position,
                quaternion=quaternion,
            )
        )
    return frames


def iter_sequence_files(input_dir: str) -> Iterator[str]:
    """Yield replayable sequence files in a directory (ref :146-159)."""
    if not osp.isdir(input_dir):
        return
    for name in sorted(os.listdir(input_dir)):
        if name.endswith((".npz", ".pkl", ".hkl")):
            yield osp.join(input_dir, name)
