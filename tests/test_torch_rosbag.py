"""Port parity: ROS bag reading, writing and playback against the JAX package.

Bags written by either package's ``write_bag`` read identically through the
other's ``RosbagReader``, and the same messages give the same bytes.  The
port's ``bag_to_frames``, ``play_bag`` and ``stream_bag_frames`` give what
the JAX package's give on the same bag.  Tolerance: none; bytes, parsed
messages and frames are compared exactly.
"""
import bz2
import dataclasses
import struct
import threading

import cv2
import numpy as np
import pytest

import vision_semantic_segmentation_tpu.runtime.bag_adapter as j_adapter
import vision_semantic_segmentation_tpu.runtime.rosbag as j_bag
import vision_semantic_segmentation_tpu_torch.runtime.bag_adapter as adapter
import vision_semantic_segmentation_tpu_torch.runtime.rosbag as bag
from vision_semantic_segmentation_tpu.runtime.bus import TopicBus as JaxBus
from vision_semantic_segmentation_tpu_torch.runtime import TopicBus
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

BAGS = {"jax": j_bag, "port": bag}


def _plain(x):
    """A message, record or frame as nested builtins, comparable across packages."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _cloud(mod, stamp, frame_id, pts, fields=("x", "y", "z", "intensity")):
    pts = np.asarray(pts, np.float32)
    data = np.ascontiguousarray(pts.T).tobytes()
    return mod.PointCloud2Msg(mod.Header(0, stamp, frame_id), 1, pts.shape[1],
                              [mod.PointField(f, 4 * i, 7, 1) for i, f in enumerate(fields)],
                              4 * len(fields), data)


def _messages(mod, seed=0, n_frames=4, image_topics=("/camera1/image_raw",)):
    """Clouds at 2 Hz, poses and images at 12 Hz (cameras interleaving),
    a /tf broadcast and, off the AVT camera topics, one compressed (lossless
    PNG) image."""
    rng = np.random.default_rng(seed)
    msgs = [("/tf", mod.TFMessageMsg([
        mod.TransformStampedMsg(mod.Header(0, 10.0, "/base_link"), "/camera1",
                                np.array([1.0, 0.0, 1.5]), np.array([0.0, 0.0, 0.1, 0.995])),
        mod.TransformStampedMsg(mod.Header(1, 10.0, "base_link"), "velodyne",
                                np.array([2.6, 0.0, 2.0]), np.array([0.0, 0.07, 0.0, 0.9975])),
    ]), 10.0)]
    for i in range(n_frames):
        stamp = 10.0 + i / 12
        if i % 6 == 0:
            msgs.append(("/reduced_map", _cloud(mod, stamp, "/world", rng.random((4, 40))), stamp))
        msgs.append(("/current_pose", mod.PoseStampedMsg(
            mod.Header(i, stamp, "/world"), rng.random(3), np.array([0.0, 0.0, 0.0, 1.0])), stamp))
        topic = image_topics[i % len(image_topics)]
        img = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
        if i == 1 and "avt" not in topic:
            ok, enc = cv2.imencode(".png", img[:, :, ::-1])
            assert ok
            msg = mod.CompressedImageMsg(mod.Header(i, stamp, ""), "png", enc.tobytes())
            topic = topic + "/compressed"
        else:
            msg = mod.ImageMsg(mod.Header(i, stamp, topic.split("/")[1]), 8, 12, "rgb8", img)
        msgs.append((topic, msg, stamp))
    return msgs


def _read(mod, path, **kw):
    return [_plain(m) for m in mod.RosbagReader(str(path)).read_messages(**kw)]


@pytest.mark.parametrize("writer", BAGS)
def test_bags_read_identically(writer, tmp_path):
    path = tmp_path / "seq.bag"
    msgs = _messages(BAGS[writer])
    BAGS[writer].write_bag(str(path), msgs)
    ours, ref = _read(bag, path), _read(j_bag, path)
    assert len(ours) == len(msgs) and ours == ref
    # the decoded payloads too: clouds, raw and compressed images
    for m, j in zip(bag.RosbagReader(str(path)).read_messages(),
                    j_bag.RosbagReader(str(path)).read_messages()):
        if hasattr(m.message, "xyzi"):
            np.testing.assert_array_equal(m.message.xyzi(), j.message.xyzi())
        if hasattr(m.message, "rgb"):
            np.testing.assert_array_equal(m.message.rgb(), j.message.rgb())


def test_same_messages_same_bytes(tmp_path):
    bag.write_bag(str(tmp_path / "port.bag"), _messages(bag))
    j_bag.write_bag(str(tmp_path / "jax.bag"), _messages(j_bag))
    assert (tmp_path / "port.bag").read_bytes() == (tmp_path / "jax.bag").read_bytes()


def _bz2_chunks(raw: bytes) -> bytes:
    """The bag with its chunk records bz2-compressed (``rosbag record -j``)."""
    u32 = struct.Struct("<I")
    off = raw.index(b"\n") + 1
    out = raw[:off]
    while off < len(raw):
        (hlen,) = u32.unpack_from(raw, off)
        header = raw[off + 4: off + 4 + hlen]
        (dlen,) = u32.unpack_from(raw, off + 4 + hlen)
        data = raw[off + 8 + hlen: off + 8 + hlen + dlen]
        if b"compression=none" in header:
            fields = bag._parse_header(header)
            fields[b"compression"] = b"bz2"
            fix, data = bag._encode_header(fields), bz2.compress(data)
            out += u32.pack(len(fix)) + fix + u32.pack(len(data)) + data
        else:
            out += raw[off: off + 8 + hlen + dlen]
        off += 8 + hlen + dlen
    return out


def test_bz2_chunks_and_topic_filter(tmp_path):
    plain = tmp_path / "plain.bag"
    bag.write_bag(str(plain), _messages(bag))
    packed = tmp_path / "bz2.bag"
    packed.write_bytes(_bz2_chunks(plain.read_bytes()))
    assert packed.read_bytes() != plain.read_bytes()
    assert _read(bag, packed) == _read(j_bag, packed) == _read(bag, plain)
    topics = ["/current_pose", "/tf"]
    ours = _read(bag, packed, topics=topics)
    assert ours == _read(j_bag, packed, topics=topics)
    assert {m[1]["topic"] for m in ours} == set(topics) and len(ours) == 5


def _truncated_cloud(mod):
    c = _cloud(mod, 1.0, "world", np.zeros((4, 10)))
    return dataclasses.replace(c, data=c.data[:-16])


def _bad_offset_cloud(mod):
    c = _cloud(mod, 1.0, "world", np.zeros((4, 10)))
    c.fields[3] = mod.PointField("intensity", 14, 7, 1)
    return c


@pytest.mark.parametrize("make,match", [
    (_truncated_cloud, "truncated"),
    (_bad_offset_cloud, "offset"),
], ids=["truncated_cloud", "field_offset"])
def test_malformed_payloads_raise(make, match):
    for mod in BAGS.values():
        with pytest.raises(ValueError, match=match):
            make(mod).xyzi()


def test_malformed_files_raise(tmp_path):
    (tmp_path / "not.bag").write_bytes(b"#ROSBAG V1.2\n")
    for mod in BAGS.values():
        with pytest.raises(ValueError, match="not a ROS bag"):
            mod.RosbagReader(str(tmp_path / "not.bag"))
    msg = bag.ImageMsg(bag.Header(0, 1.0, "c"), 2, 2, "rgb8", np.zeros((2, 2, 3), np.uint8))
    _, payload = bag.serialize_message(msg)
    payload = payload.replace(b"rgb8", b"yuv8")
    for mod in BAGS.values():
        with pytest.raises(ValueError, match="encoding"):
            mod._deser_image(payload)
    broken = bag.CompressedImageMsg(bag.Header(0, 1.0, "c"), "png", b"not a png")
    with pytest.raises(ValueError, match="cannot decode"):
        broken.rgb()


def test_lossless_compressed_image(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    ok, enc = cv2.imencode(".png", img[:, :, ::-1])
    bag.write_bag(str(tmp_path / "c.bag"), [(
        "/camera1/image_raw/compressed",
        bag.CompressedImageMsg(bag.Header(0, 1.0, "camera1"), "png", enc.tobytes()), 1.0)])
    (rec,) = bag.RosbagReader(str(tmp_path / "c.bag")).read_messages()
    np.testing.assert_array_equal(rec.message.rgb(), img)


# -- the adapter ----------------------------------------------------------------
@pytest.fixture
def drive_bag(tmp_path):
    """Two AVT camera streams (renamed to /cameraX/image_raw by the adapter)."""
    path = tmp_path / "drive.bag"
    bag.write_bag(str(path), _messages(bag, seed=7, n_frames=12, image_topics=(
        "/avt_cameras/camera1/image_color", "/avt_cameras/camera6/image_color")))
    return str(path)


def _frames_plain(frames):
    return [[f.camera, f.pcd_frame_id, f.stamp, *(_plain(np.asarray(a)) for a in (
        f.pcd, f.semantic_image, f.position, f.quaternion))] for f in frames]


def test_bag_to_frames_matches(drive_bag):
    topic = "/avt_cameras/camera6/image_color"
    ours = adapter.bag_to_frames(drive_bag, image_topic=topic)
    ref = j_adapter.bag_to_frames(drive_bag, image_topic=topic)
    assert len(ours) == 6 and ours[0].camera == "camera6"
    assert _frames_plain(ours) == _frames_plain(ref)


def _recording(bus):
    seen = []
    for topic in ("/camera1/image_raw", "/camera6/image_raw", "/ndt_pose", "/reduced_map", "/tf"):
        bus.subscribe(topic, lambda m, t=topic: seen.append((t, m.stamp, m.frame_id, _plain(
            np.asarray(m.data) if not hasattr(m.data, "transforms") else m.data.transforms)
            if not isinstance(m.data, tuple) else [_plain(np.asarray(a)) for a in m.data])))
    return seen


def test_play_bag_matches(drive_bag):
    """AVT topics renamed onto the bus, plus a caller's rename of the pose topic."""
    renames = {"/current_pose": "/ndt_pose"}
    bus, jbus = TopicBus(), JaxBus()
    ours, ref = _recording(bus), _recording(jbus)
    n = adapter.play_bag(drive_bag, bus, topic_map=renames)
    assert n == j_adapter.play_bag(drive_bag, jbus, topic_map=renames) == 27
    assert ours == ref
    assert bus.published_counts["/camera6/image_raw"] == 6
    assert bus.published_counts["/ndt_pose"] == 12


def test_stream_bag_frames_matches(drive_bag):
    cams = ["/camera1/image_raw", "/camera6/image_raw"]
    ours = list(adapter.stream_bag_frames(drive_bag, image_topics=cams, with_tf=True))
    ref = list(j_adapter.stream_bag_frames(drive_bag, image_topics=cams, with_tf=True))
    assert len(ours) == len(ref) == 13
    assert isinstance(ours[0], adapter.TFRecord) and ours[0].stamp == ref[0].stamp
    assert _plain(ours[0].msg) == _plain(ref[0].msg)
    assert _frames_plain(ours[1:]) == _frames_plain(ref[1:])
    assert [f.camera for f in ours[1:5]] == ["camera1", "camera6"] * 2


def test_stream_bag_frames_unpacks_each_cloud_once(drive_bag, monkeypatch):
    """Two cameras interleaving between two clouds: the memo keeps both."""
    calls = []
    xyzi = bag.PointCloud2Msg.xyzi
    monkeypatch.setattr(bag.PointCloud2Msg, "xyzi", lambda self: calls.append(1) or xyzi(self))
    frames = list(adapter.stream_bag_frames(
        drive_bag, image_topics=["/camera1/image_raw", "/camera6/image_raw"], lookahead_s=0.0))
    assert len(frames) == 12 and len(calls) == 2
    assert len({id(f.pcd) for f in frames}) == 2


def _decoder_alive() -> bool:
    return any(t.name == "bag-decoder" and t.is_alive() for t in threading.enumerate())


def test_stream_bag_frames_reaps_its_worker(drive_bag, tmp_path):
    stream = adapter.stream_bag_frames(drive_bag, max_buffered=1)
    next(stream)
    assert _decoder_alive()
    stream.close()  # the consumer goes away with the decoder blocked on a full queue
    assert not _decoder_alive()
    # a reader error reaches the consumer
    raw = open(drive_bag, "rb").read()
    (tmp_path / "cut.bag").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(struct.error):
        list(adapter.stream_bag_frames(str(tmp_path / "cut.bag")))
    assert not _decoder_alive()


# -- TF tree and ROS helpers -----------------------------------------------------------
def _tf_trees():
    from vision_semantic_segmentation_tpu.utils.ros_compat import TransformTree as JaxTree
    from vision_semantic_segmentation_tpu_torch.utils import TransformTree

    trees = TransformTree(), JaxTree()
    for tree in trees:
        tree.set_pose([2.64, 0.0, 1.98], [0.0, 0.07, 0.0, 0.9975], "base_link", "velodyne")
        tree.set_pose([0.05, 0.3, -0.06], [-0.5, 0.49, -0.5, 0.51], "velodyne", "camera1")
        tree.set_pose([10.0, -3.0, 0.0], [0.0, 0.0, 0.38, 0.92], "world", "base_link", stamp=4.0)
        tree.set_transform("world", "local_map", np.eye(4))
    return trees


def test_transform_tree_matches():
    """Lookups through a common root; float64 here, where the JAX package's
    quaternion matrix runs in f32 (x64 off): atol 1e-6."""
    ours, ref = _tf_trees()
    for to, frm in (("base_link", "camera1"), ("camera1", "local_map"), ("world", "camera1")):
        np.testing.assert_allclose(ours.lookup(to, frm), ref.lookup(to, frm), atol=1e-6, rtol=0)
    ours.set_pose([0, 0, 0], [0, 0, 0, 1], "odom", "other")
    with pytest.raises(LookupError, match="not connected"):
        ours.lookup("world", "other")
    assert ours.get_transformation("other", "world") == (None, None)
    T, t = ours.get_transformation("camera1", "world")
    np.testing.assert_array_equal(t, T[:3, 3])


def test_ros_helpers_match():
    from vision_semantic_segmentation_tpu.geometry.camera import (
        camera_from_extrinsic as j_from_extrinsic,
        get_camera as j_get_camera,
    )
    from vision_semantic_segmentation_tpu.utils import ros_compat as j_ros
    from vision_semantic_segmentation_tpu_torch.geometry import camera_from_extrinsic, get_camera
    from vision_semantic_segmentation_tpu_torch.utils import ros_compat

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    packed = ros_compat.pack_rgba(rgb)
    np.testing.assert_array_equal(packed, j_ros.pack_rgba(rgb))
    np.testing.assert_array_equal(ros_compat.unpack_rgba(packed)[:, :3], rgb)
    xyz = rng.random((50, 3))
    ours, ref = ros_compat.create_point_cloud(xyz, rgb), j_ros.create_point_cloud(xyz, rgb)
    assert ours["fields"] == ref["fields"] and ours["data"].tobytes() == ref["data"].tobytes()
    q = np.array([0.1, -0.2, 0.3, 0.9])
    np.testing.assert_allclose(ros_compat.get_normal_from_pose(np.zeros(3), q),
                               j_ros.get_normal_from_pose(np.zeros(3), q), atol=1e-6, rtol=0)
    T = _tf_trees()[0].lookup("velodyne", "camera1")
    cam, j_cam = camera_from_extrinsic(get_camera("camera6"), T), j_from_extrinsic(
        j_get_camera("camera6"), T)
    np.testing.assert_array_equal(cam.P, j_cam.P)
    assert cam.id == 6 and cam.im_size == j_cam.im_size
