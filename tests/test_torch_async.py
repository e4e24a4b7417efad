"""Port parity: the online runtime (executors, timed bag playback) against the JAX package.

``NodeExecutor`` mailboxes and threads, and ``run_online`` over a small bag
for the two-node topology and ``FusedOnlineNode``, fed by ``play_bag_timed``
and by the decode-ahead ``play_stream_timed``, in the port and in the JAX
package on the CPU, with the same weights (a Dummy network, as the JAX
package's own online tests use; rectified 1440x1920 frames scaled 32x
before it).  On the CPU every kernel wrapper runs its plain version.
Tolerance: grids atol 1e-4 (the nodes' image paths and the fold's sum order
differ, as in ``tests/test_torch_online.py``); counts exactly.  On a bag
whose ``/tf`` moves camera1 inside the decode-ahead window, the port's two
feeds give the same grid and the JAX package's decode-ahead feed another:
it applies the transform before the frame it follows (the deviation the
port repairs).
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import vision_semantic_segmentation_tpu.runtime.bus as j_bus_mod
import vision_semantic_segmentation_tpu.runtime.node as j_node_mod
from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.inference.predictor import SemanticSegmentation as JaxSeg
from vision_semantic_segmentation_tpu.mapping.engine import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.runtime.async_bus import run_online as j_run_online
from vision_semantic_segmentation_tpu.runtime.pipeline import FusedFramePipeline as JaxPipeline
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation
from vision_semantic_segmentation_tpu_torch.models import flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline, TopicBus
from vision_semantic_segmentation_tpu_torch.runtime import rosbag
from vision_semantic_segmentation_tpu_torch.runtime.async_bus import NodeExecutor, run_online

from test_torch_online import CAMERAS, N_FRAMES, _cfg, _frames
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


# -- NodeExecutor ------------------------------------------------------------------
def test_callbacks_run_off_the_publisher_thread():
    bus, ex = TopicBus(), NodeExecutor("t")
    seen = []
    ex.subscribe(bus, "/a", lambda m: seen.append(threading.get_ident()))
    bus.publish("/a", 1)
    assert ex.join(timeout=5.0)
    ex.stop()
    assert seen and seen[0] != threading.get_ident()
    assert not ex._thread.is_alive()


def test_keep_latest_drops_oldest_and_counts():
    bus, ex = TopicBus(), NodeExecutor("slow")
    gate, got = threading.Event(), []
    ex.subscribe(bus, "/img", lambda m: gate.wait(timeout=5.0) and got.append(m.data),
                 queue_size=1)
    bus.publish("/img", 0)  # the worker takes it and blocks on the gate
    deadline = time.monotonic() + 5.0
    while ex.pending() != 1 or ex._queues["/img"]:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    for i in range(1, 6):
        bus.publish("/img", i)  # mailbox depth 1: 1..4 dropped
    gate.set()
    assert ex.join(timeout=5.0)
    ex.stop()
    assert got == [0, 5] and ex.drops["/img"] == 4 and ex.processed["/img"] == 2


def test_deep_queue_keeps_history_and_errors_leave_the_worker_alive():
    bus, ex = TopicBus(), NodeExecutor("hist")
    got = []

    def cb(m):
        if m.data == 3:
            raise RuntimeError("a bad message")
        got.append(m.data)

    ex.subscribe(bus, "/pose", cb, queue_size=64)
    for i in range(50):
        bus.publish("/pose", i)
    assert ex.join(timeout=5.0)
    assert ex._thread.is_alive()
    ex.stop()
    assert got == [i for i in range(50) if i != 3]
    assert ex.drops["/pose"] == 0 and ex.errors["/pose"] == 1 and ex.processed["/pose"] == 49
    with pytest.raises(ValueError, match="already routed"):
        ex.subscribe(bus, "/pose", cb)


def test_many_publishers_lose_nothing():
    """More publisher threads than cores into one deep mailbox, with the
    interpreter switching threads as often as it can: every message is
    processed once, none dropped, none twice."""
    bus, ex = TopicBus(), NodeExecutor("stress")
    got = []
    ex.subscribe(bus, "/x", got.append, queue_size=1 << 16)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [bus.publish("/x", (k, i))
                                                        for i in range(200)])
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert ex.join(timeout=30.0)
    ex.stop()
    assert sorted(m.data for m in got) == [(k, i) for k in range(16) for i in range(200)]
    assert ex.drops["/x"] == 0 and ex.processed["/x"] == 3200


# -- run_online ------------------------------------------------------------------
@pytest.fixture(scope="module")
def online(tmp_path_factory):
    """A bag of the online frames (1 s apart, played at 2x; cameras
    alternating, so a camera's keep-latest mailbox drops a frame only if its
    node stalls for about a second), Dummy weights, and configs whose
    outputs go to separate directories.  Each image is stamped 10 ms after
    its cloud and pose: the reference's nearest-stamp rule takes the NEWEST
    entry on an exact tie, so with equal stamps a frame that reaches the
    mapping node after the next cloud would pair with that cloud, and the
    grid would depend on thread timing."""
    root = tmp_path_factory.mktemp("async")
    cfgs = {}
    for name, make in (("jax", j_cfg_defaults), ("port", get_cfg_defaults)):
        cfg = _cfg(make, root / name)
        cfg.VISION_SEM_SEG.UNDISTORT = False
        cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.TYPE = "Dummy"
        cfg.TEST_END_TIME = 1e12
        cfgs[name] = cfg
    jnet = cfgs["jax"].VISION_SEM_SEG.SEM_SEG_NETWORK
    variables = j_build_model(jnet)[0].init(jax.random.PRNGKey(1), jnp.zeros((1, 45, 60, 3)))
    variables = jax.tree.map(np.asarray, dict(variables))
    frames = _frames(np.random.default_rng(33))
    msgs = []
    for i in range(N_FRAMES):
        stamp, cam = 1.0 + i, CAMERAS[i % 2]
        pts = frames["pcd"][i]
        msgs.append(("/reduced_map", rosbag.PointCloud2Msg(
            rosbag.Header(i, stamp, "world"), 1, pts.shape[1],
            [rosbag.PointField(f, 4 * k, 7, 1) for k, f in enumerate(("x", "y", "z", "intensity"))],
            16, np.ascontiguousarray(pts.T).tobytes()), stamp))
        msgs.append(("/current_pose", rosbag.PoseStampedMsg(
            rosbag.Header(i, stamp, "world"), frames["position"][i].astype(np.float64),
            frames["quaternion"][i].astype(np.float64)), stamp))
        msgs.append((f"/{cam}/image_raw", rosbag.ImageMsg(
            rosbag.Header(i, stamp + 0.01, cam), 1440, 1920, "rgb8", frames["image"][i]),
            stamp + 0.01))
    bag = str(root / "drive.bag")
    rosbag.write_bag(bag, msgs)
    return dict(cfgs=cfgs, variables=variables, bag=bag, frames=frames)


def _recording(monkeypatch, module, name):
    """Record the nodes ``run_online`` builds from ``module.name``."""
    made = []
    base = getattr(module, name)

    class Recording(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    monkeypatch.setattr(module, name, Recording)
    return made


def _warm_jax(online, fused):
    """Compile the JAX package's programs before the timed playback, so that
    its first frames are not dropped while XLA compiles."""
    cfg, variables = online["cfgs"]["jax"], online["variables"]
    f = online["frames"]
    engine = JaxEngine(cfg)
    pcd = np.zeros((4, cfg.MAPPING.POINT_BUCKET), np.float32)
    valid = np.zeros(cfg.MAPPING.POINT_BUCKET, bool)
    if fused:
        pipe = JaxPipeline(cfg, variables, engine=engine, distortion="none",
                           compute_dtype=jnp.float32)
        for cam in CAMERAS:
            pipe.step(pipe.init_grid(), f["image"][0], pcd, valid, f["position"][0],
                      f["quaternion"][0], camera=cam)
        return dict(pipeline=pipe)
    predictor = JaxSeg(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, variables=variables,
                       compute_dtype="float32")
    bus = j_bus_mod.TopicBus()
    j_node_mod.SegmentationNode(cfg, bus, predictor=predictor)
    for cam in CAMERAS:
        bus.publish(f"/{cam}/image_raw", f["image"][0], frame_id=cam)
        engine.step(engine.init_grid(), pcd, valid, f["image"][0], f["position"][0],
                    f["quaternion"][0], camera=cam)
    return dict(predictor=predictor, engine=engine)


@pytest.mark.parametrize("fused", [False, True], ids=["two_node", "fused_node"])
def test_run_online_fuses_every_frame_and_matches(online, fused, monkeypatch):
    cfg = online["cfgs"]["port"]
    if fused:
        kw = dict(pipeline=FusedFramePipeline(
            cfg, state_dict=flax_to_state_dict(online["variables"]), distortion="none",
            compute_dtype=torch.float32, device="cpu"))
    else:
        kw = dict(predictor=SemanticSegmentation(
            cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, variables=online["variables"],
            compute_dtype="float32", device="cpu"))
    report = run_online(cfg, online["bag"], rate=2.0, fused=fused, device="cpu", **kw)
    assert report.fused_frames == N_FRAMES and report.dropped_frames == 0
    assert report.dropped_total == 0 and not report.errors
    assert report.published == 3 * N_FRAMES and report.max_lag_s < 0.5
    prefix = "fused" if fused else "map"
    assert report.processed[f"{prefix}:/current_pose"] == N_FRAMES
    if not fused:
        assert report.processed["seg:/camera1/image_raw"] == N_FRAMES // 2

    j_nodes = _recording(monkeypatch, j_node_mod, "FusedOnlineNode" if fused else "MappingNode")
    j_report = j_run_online(online["cfgs"]["jax"], online["bag"], rate=2.0, fused=fused,
                            **_warm_jax(online, fused))
    assert j_report.dropped_total == 0 and j_nodes[0].fused_frames == N_FRAMES
    j_grid = np.asarray(j_nodes[0].grid)
    assert (j_grid != 0).sum() > 100
    np.testing.assert_allclose(report.grid.numpy(), j_grid, atol=1e-4, rtol=0)


# -- the decode-ahead feed ------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["two_node", "fused_node"])
def test_decode_ahead_matches_timed_playback(online, fused, monkeypatch):
    """``run_online(decode_ahead=True)`` on a bag whose extrinsics do not
    move: the same grid and counts as the port's ``play_bag_timed`` feed and
    as the JAX package's decode-ahead feed."""
    cfg = online["cfgs"]["port"]
    reports = {}
    for decode_ahead in (True, False):
        reports[decode_ahead] = run_online(cfg, online["bag"], rate=2.0, fused=fused,
                                           decode_ahead=decode_ahead, device="cpu",
                                           **_port_parts(online, fused))
    ours = reports[True]
    assert ours.fused_frames == N_FRAMES and ours.dropped_frames == 0
    assert ours.dropped_total == 0 and not ours.errors and ours.max_lag_s < 0.5
    assert ours.published == reports[False].published == 3 * N_FRAMES
    assert ours.processed == reports[False].processed
    torch.testing.assert_close(ours.grid, reports[False].grid, rtol=0, atol=1e-4)

    j_nodes = _recording(monkeypatch, j_node_mod, "FusedOnlineNode" if fused else "MappingNode")
    j_report = j_run_online(online["cfgs"]["jax"], online["bag"], rate=2.0, fused=fused,
                            decode_ahead=True, **_warm_jax(online, fused))
    assert j_report.dropped_total == 0 and j_nodes[0].fused_frames == N_FRAMES
    assert j_report.published == ours.published
    np.testing.assert_allclose(ours.grid.numpy(), np.asarray(j_nodes[0].grid), atol=1e-4,
                               rtol=0)


def _port_parts(online, fused):
    """A fresh f32 pipeline (fused) or predictor (two-node) on the CPU."""
    cfg = online["cfgs"]["port"]
    if fused:
        return dict(pipeline=FusedFramePipeline(
            cfg, state_dict=flax_to_state_dict(online["variables"]), distortion="none",
            compute_dtype=torch.float32, device="cpu"))
    return dict(predictor=SemanticSegmentation(
        cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, variables=online["variables"],
        compute_dtype="float32", device="cpu"))


def _tf_message(stamp, camera1_quaternion):
    """velodyne -> base_link and velodyne -> camera1 (a forward-looking camera)."""
    return rosbag.TFMessageMsg([
        rosbag.TransformStampedMsg(rosbag.Header(0, stamp, "velodyne"), "base_link",
                                   np.array([-2.64, 0.0, -1.98]), np.array([0, 0, 0, 1.0])),
        rosbag.TransformStampedMsg(rosbag.Header(0, stamp, "velodyne"), "camera1",
                                   np.array([0.05, 0.3, -0.06]), camera1_quaternion),
    ])


CAMERA1_A = np.array([-0.5, 0.49, -0.5, 0.51])
# the same camera turned 3 degrees about the vehicle's vertical axis
CAMERA1_B = (Rotation.from_euler("z", 3, degrees=True) * Rotation.from_quat(CAMERA1_A)).as_quat()


@pytest.fixture(scope="module")
def moved_bag(online, tmp_path_factory):
    """The online bag with camera1's extrinsics on ``/tf`` at 0.5 s (A),
    moved 0.29 s after camera1's first frame (B, at 1.3 s): inside the
    decode-ahead window of that frame (0.5 s), so a feed that applies /tf
    as it reads it gives the frame B."""
    root = tmp_path_factory.mktemp("moved")
    msgs = list(rosbag.RosbagReader(online["bag"]).read_messages())
    records = [("/tf", _tf_message(0.5, CAMERA1_A), 0.5)]
    for m in msgs:
        if m.stamp > 1.3 >= records[-1][2]:
            records.append(("/tf", _tf_message(1.3, CAMERA1_B), 1.3))
        records.append((m.topic, m.message, m.stamp))
    bag = str(root / "moved.bag")
    rosbag.write_bag(bag, records)
    return bag


def _camera1_from(quaternion):
    from vision_semantic_segmentation_tpu_torch.geometry.camera import (
        camera_from_extrinsic, get_camera)
    from vision_semantic_segmentation_tpu_torch.mapping.engine import velodyne_to_baselink
    from vision_semantic_segmentation_tpu_torch.utils.ros_compat import TransformTree

    tree = TransformTree()
    for tr in _tf_message(0.0, quaternion).transforms:
        tree.set_pose(tr.translation, tr.rotation, parent=tr.header.frame_id,
                      child=tr.child_frame_id)
    T_cam_to_velo = np.linalg.inv(velodyne_to_baselink()) @ tree.lookup("base_link", "camera1")
    return camera_from_extrinsic(get_camera("camera1"), T_cam_to_velo)


def test_decode_ahead_applies_tf_on_the_timeline(online, moved_bag, monkeypatch):
    """The moved-extrinsic bag, fused topology: the port registers for
    camera1 the extrinsics in force at its first frame's stamp (A), under
    both feeds, and the two grids are equal.  The JAX package's decode-ahead
    feed applies the 1.3 s transform before that frame and registers B: its
    grid differs.  That difference is the deviation the port repairs."""
    cfg = online["cfgs"]["port"]
    want_a, want_b = _camera1_from(CAMERA1_A), _camera1_from(CAMERA1_B)
    grids = {}
    for decode_ahead in (True, False):
        parts = _port_parts(online, fused=True)
        report = run_online(cfg, moved_bag, rate=2.0, fused=True, decode_ahead=decode_ahead,
                            device="cpu", **parts)
        assert report.fused_frames == N_FRAMES and report.dropped_total == 0
        assert report.published == 3 * N_FRAMES + 2 and not report.errors
        np.testing.assert_allclose(parts["pipeline"].engine.cameras["camera1"].R, want_a.R,
                                   atol=1e-12)
        grids[decode_ahead] = report.grid
    torch.testing.assert_close(grids[True], grids[False], rtol=0, atol=1e-4)

    j_nodes = _recording(monkeypatch, j_node_mod, "FusedOnlineNode")
    j_variables = online["variables"]
    j_run_online(online["cfgs"]["jax"], moved_bag, rate=2.0, fused=True, decode_ahead=True,
                 pipeline=JaxPipeline(online["cfgs"]["jax"], j_variables, distortion="none",
                                      compute_dtype=jnp.float32))
    j_cam = j_nodes[0].engine.cameras["camera1"]
    np.testing.assert_allclose(j_cam.R, want_b.R, atol=1e-6)
    assert not np.allclose(want_a.R, want_b.R, atol=1e-3)
    assert not np.allclose(np.asarray(j_nodes[0].grid), grids[True].numpy(), atol=1e-4)


def _published(feed, bag, **kw):
    """(topic, stamp) of everything a feed publishes, in order."""
    bus = TopicBus()
    seen = []
    for topic in ("/tf", "/reduced_map", "/current_pose", "/camera1/image_raw",
                  "/camera6/image_raw"):
        bus.subscribe(topic, lambda m, t=topic: seen.append((t, round(m.stamp, 6))))
    feed(bag, bus, rate=50.0, **kw)
    return seen


def test_play_stream_timed_holds_tf_until_its_stamp(moved_bag):
    """Each ``/tf`` comes out after every frame stamped before it and before
    every frame stamped after it, as under ``play_bag_timed``; each cloud once,
    at its own stamp (each pose goes out at its frame's stamp, after the
    sync); the JAX feed publishes the 1.3 s transform before the 1.01 s
    frame."""
    from vision_semantic_segmentation_tpu.runtime.async_bus import (
        play_stream_timed as j_play_stream_timed)
    from vision_semantic_segmentation_tpu.utils.ros_compat import TransformTree as JaxTree
    from vision_semantic_segmentation_tpu_torch.runtime.async_bus import (
        play_bag_timed, play_stream_timed)

    cams = ["/camera1/image_raw", "/camera6/image_raw"]
    ours = _published(play_stream_timed, moved_bag, image_topics=cams, with_tf=True)
    timed = _published(play_bag_timed, moved_bag)
    assert len(ours) == len(timed) == 3 * N_FRAMES + 2

    def frames_and_tf(seen):
        return [m for m in seen if m[0] not in ("/reduced_map", "/current_pose")]

    assert frames_and_tf(ours) == frames_and_tf(timed)
    clouds = [m for m in ours if m[0] == "/reduced_map"]
    assert clouds == [m for m in timed if m[0] == "/reduced_map"]
    tf_at = ours.index(("/tf", 1.3))
    assert ours[tf_at - 1] == ("/camera1/image_raw", 1.01)
    j_ours = _published(j_play_stream_timed, moved_bag, image_topics=cams,
                        tf_tree=JaxTree())
    assert j_ours.index(("/tf", 1.3)) < j_ours.index(("/camera1/image_raw", 1.01))
