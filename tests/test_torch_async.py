"""Port parity: the online runtime (executors, timed bag playback) against the JAX package.

``NodeExecutor`` mailboxes and threads, and ``run_online`` over a small bag
for the two-node topology and ``FusedOnlineNode``, in the port and in the
JAX package on the CPU, with the same weights (a Dummy network, as the JAX
package's own online tests use; rectified 1440x1920 frames scaled 32x
before it).  On the CPU every kernel wrapper runs its plain version.
Tolerance: grids atol 1e-4 (the nodes' image paths and the fold's sum order
differ, as in ``tests/test_torch_online.py``); counts exactly.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_decode_ahead_is_refused(online):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7.2"):
        run_online(online["cfgs"]["port"], online["bag"], decode_ahead=True, device="cpu")
