"""Port parity: hickle (``.hkl``) and pickled recorded inputs against the JAX package.

A ``.hkl`` written by either package's ``dump_hickle`` loads equal through
the other's ``load_hickle``; ``load_reference_dump`` of a reference-layout
input list (``.hkl`` or ``.pkl``; poses as genpy messages, dicts or
7-vectors) gives the JAX package's ``FrameRecord``s.  Tolerance: none.
"""
import pickle
import sys
import types

import numpy as np
import pytest

import vision_semantic_segmentation_tpu.runtime.hickle_io as j_hkl
import vision_semantic_segmentation_tpu_torch.runtime.hickle_io as hkl
from vision_semantic_segmentation_tpu.runtime.io import load_reference_dump as j_load_dump
from vision_semantic_segmentation_tpu_torch.runtime.io import (
    iter_sequence_files,
    load_reference_dump,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

IO = {"jax": j_hkl, "port": hkl}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple, set)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(sorted(a) if isinstance(a, set) else a,
                                                      sorted(b) if isinstance(b, set) else b)))
    return type(a) is type(b) and a == b


def _payload(rng):
    return {
        "a": [1, 2, 3], "b": (1.5, "two"), "c": {"nested": True, "none": None},
        "raw": b"\x00\x01\x02", "n": 42, "f": -0.25, 7: "int key", (1, 2): "tuple key",
        "/camera1/image_raw": "a key with slashes",
        "arrays": [rng.random((4, 17)), rng.integers(0, 255, (3, 5, 2), dtype=np.uint8)],
        "long": list(range(12)),
    }


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_hickle_files_load_equal(writer, reader, tmp_path):
    obj = _payload(np.random.default_rng(0))
    path = str(tmp_path / "x.hkl")
    IO[writer].dump_hickle(obj, path)
    got = IO[reader].load_hickle(path)
    assert _equal(got, obj)
    assert _equal(got, IO[writer].load_hickle(path))


def _install_ros_like_modules(monkeypatch):
    """genpy-style Pose/Point/Quaternion under the real ROS module paths, so
    that pickling records ``geometry_msgs.msg._Pose.Pose`` etc., as a
    reference-produced dump does."""
    made = {}
    for mod_name, cls_name, slots in [
        ("geometry_msgs.msg._Point", "Point", ("x", "y", "z")),
        ("geometry_msgs.msg._Quaternion", "Quaternion", ("x", "y", "z", "w")),
        ("geometry_msgs.msg._Pose", "Pose", ("position", "orientation")),
    ]:
        cls = type(cls_name, (hkl.RosMessageStub,), {"__module__": mod_name, "__slots__": slots})
        mod = types.ModuleType(mod_name)
        setattr(mod, cls_name, cls)
        monkeypatch.setitem(sys.modules, mod_name, mod)
        made[cls_name] = cls
    for pkg in ("geometry_msgs", "geometry_msgs.msg"):
        monkeypatch.setitem(sys.modules, pkg, types.ModuleType(pkg))
    return made


def _input_list(rng, pose_of):
    """The reference's recorded layout (ref mapping.py:309-313)."""
    return [{
        "pcd": rng.random((4, 30)).astype(np.float32),
        "pcd_frame_id": ("world", "velodyne")[i % 2],
        "semantic_image": rng.integers(0, 256, (6, 8, 3), dtype=np.uint8),
        "pose": pose_of(np.float64([i, 2.0 * i, 0.5]), np.float64([0.0, 0.0, 0.6, 0.8])),
    } for i in range(3)]


def _frames_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.pcd_frame_id, x.camera, x.stamp) == (y.pcd_frame_id, y.camera, y.stamp)
        for k in ("pcd", "semantic_image", "position", "quaternion"):
            assert _equal(np.asarray(getattr(x, k)), np.asarray(getattr(y, k))), k


def test_reference_dump_hkl_with_genpy_poses(tmp_path, monkeypatch):
    ros = _install_ros_like_modules(monkeypatch)

    def genpy_pose(p, q):
        return ros["Pose"](ros["Point"](*p), ros["Quaternion"](*q))

    path = str(tmp_path / "input_list.hkl")
    j_hkl.dump_hickle(_input_list(np.random.default_rng(1), genpy_pose), path)
    for name in ("geometry_msgs.msg._Pose", "geometry_msgs.msg._Point",
                 "geometry_msgs.msg._Quaternion"):
        monkeypatch.delitem(sys.modules, name)  # loading needs no ROS installation
    frames = load_reference_dump(path)
    _frames_equal(frames, j_load_dump(path))
    assert frames[1].position.tolist() == [1.0, 2.0, 0.5]
    assert isinstance(hkl.load_hickle(path)[0]["pose"], hkl.Pose)


@pytest.mark.parametrize("pose_form", ["dict_of_dicts", "dict_of_arrays", "vector7"])
def test_reference_dump_pkl(pose_form, tmp_path):
    pose_of = {
        "dict_of_dicts": lambda p, q: {"position": dict(zip("xyz", p)),
                                       "orientation": dict(zip("xyzw", q))},
        "dict_of_arrays": lambda p, q: {"position": p, "orientation": q},
        "vector7": lambda p, q: np.concatenate([p, q]),
    }[pose_form]
    path = str(tmp_path / "input_list.pkl")
    with open(path, "wb") as f:
        pickle.dump(_input_list(np.random.default_rng(2), pose_of), f)
    frames = load_reference_dump(path)
    _frames_equal(frames, j_load_dump(path))
    assert frames[2].quaternion.tolist() == [0.0, 0.0, 0.6, 0.8]


def test_unknown_class_becomes_inert_stub():
    """A pickled global outside numpy and the ROS stubs is not resolved."""
    blob = pickle.dumps(types.SimpleNamespace(a=1))
    obj = hkl._loads(blob)
    assert type(obj).__name__ == "SimpleNamespace" and obj.a == 1
    assert getattr(type(obj), "_hickle_stub_for") == "types.SimpleNamespace"


def test_iter_sequence_files(tmp_path):
    for name in ("b.hkl", "a.npz", "c.pkl", "notes.txt", "d.bag"):
        (tmp_path / name).write_bytes(b"")
    assert [p.rsplit("/", 1)[1] for p in iter_sequence_files(str(tmp_path))] == [
        "a.npz", "b.hkl", "c.pkl"]
    assert list(iter_sequence_files(str(tmp_path / "missing"))) == []
