"""Concurrent node execution over the topic bus: the online runtime.

Port of ``vision_semantic_segmentation_tpu/runtime/async_bus.py``.  The
reference runs its two nodes as separate processes wired by ROS topics
(ref scripts/launch/camera1_mapping.launch:6-9): each node consumes on its
own callback thread, and a node that falls behind drops frames rather than
stalling the producer (ref README.md:194; mapping.py:281-284).  Here:

  * :class:`NodeExecutor` — one worker thread per node; it subscribes to
    bus topics with an *enqueue* callback, so ``bus.publish`` never runs
    node work inline, and the node's callbacks run serially on the worker.
  * Per-topic bounded mailboxes with keep-latest drops: a full mailbox
    drops its OLDEST message and counts it.
  * Stage overlap: the segmentation node's forward and the mapping node's
    fusion are enqueued from two threads onto the card's default stream.
    A tensor published by one node is read by the other's work on that
    same stream, after the work that made it; no callback synchronises the
    device, so neither thread waits for the other's kernels.

:func:`run_online` (``pipeline --rate`` on the command line) drives a bag
through the node topology at a wall-clock rate and reports drops and lag,
fed by :func:`play_bag_timed` or, with ``decode_ahead=True``, by
:func:`play_stream_timed`, which decodes the bag on a worker thread.  The
decode-ahead feed deviates from the JAX package's on purpose: it holds each
``/tf`` until the timeline reaches its stamp (the JAX feed applies it up to
``lookahead_s`` early, before the frames it follows), it leaves the TF tree
to the node's ``/tf`` subscription (the JAX feed also sets the tree itself,
so every transform is applied twice), and it publishes each cloud once,
keyed on the cloud's stamp (not on the identity of the last one).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Optional, Sequence

import torch

from ..device import DeviceLike
from .bus import Message, TopicBus

__all__ = ["NodeExecutor", "PlaybackReport", "play_bag_timed", "play_stream_timed",
           "run_online"]

log = logging.getLogger(__name__)


class NodeExecutor:
    """Runs one node's callbacks serially on a dedicated worker thread.

    Messages arrive from bus-publisher threads into per-topic bounded
    mailboxes; the worker drains them in arrival order.  A full mailbox
    drops its oldest entry (counted in :attr:`drops`), like a saturated
    ROS subscriber queue, instead of blocking the producer.  A callback
    that raises is counted in :attr:`errors` and logged; the worker goes on.
    """

    def __init__(self, name: str = "node"):
        self.name = name
        self._lock = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._callbacks: Dict[str, Callable[[Message], None]] = {}
        self._order: deque = deque()  # topics with pending messages, FIFO
        self.drops: Dict[str, int] = defaultdict(int)
        self.processed: Dict[str, int] = defaultdict(int)
        self.errors: Dict[str, int] = defaultdict(int)
        self._stop = False
        self._idle = threading.Condition()
        self._busy = 0
        self._thread = threading.Thread(target=self._run, name=f"executor-{name}", daemon=True)
        self._started = False

    # -- wiring ---------------------------------------------------------------
    def subscribe(self, bus: TopicBus, topic: str, callback: Callable[[Message], None],
                  queue_size: int = 1) -> None:
        """Route ``topic`` through this executor into ``callback``.

        ``queue_size=1`` gives keep-latest semantics (camera frames);
        history topics (pose, point cloud, tf) take a depth that covers the
        node's own sync-queue window.
        """
        if topic in self._callbacks:
            raise ValueError(f"{topic} already routed through executor {self.name}")
        self._queues[topic] = deque(maxlen=max(1, int(queue_size)))
        self._callbacks[topic] = callback
        bus.subscribe(topic, lambda msg, _t=topic: self._enqueue(_t, msg))

    def _enqueue(self, topic: str, msg: Message) -> None:
        with self._lock:
            q = self._queues[topic]
            if len(q) == q.maxlen:
                q.popleft()
                self.drops[topic] += 1
            q.append(msg)
            self._order.append(topic)
            self._lock.notify()
        if not self._started:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        # under _lock: two publisher threads may race the first enqueue
        with self._lock:
            if self._started:
                return
            self._started = True
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._order and not self._stop:
                    self._lock.wait(timeout=0.1)
                if self._stop and not self._order:
                    return
                msg = None
                while self._order and msg is None:
                    topic = self._order.popleft()
                    q = self._queues[topic]
                    # a dropped message leaves a stale order entry behind
                    if q:
                        msg = q.popleft()
                if msg is None:
                    continue
                self._busy += 1
            try:
                self._callbacks[topic](msg)
                self.processed[topic] += 1
            except Exception:  # a bad message must not kill the worker
                self.errors[topic] += 1
                log.exception("executor %s: callback for %s raised", self.name, topic)
            finally:
                with self._lock:
                    self._busy -= 1
                with self._idle:
                    self._idle.notify_all()

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values()) + self._busy

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued message has been processed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self.pending():
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=0.05 if remaining is None else min(remaining, 0.05))
        return True

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._started:
            self._thread.join(timeout=5.0)


@dataclasses.dataclass
class PlaybackReport:
    """What happened during a rate-driven playback.

    ``fused_frames``, ``dropped_frames`` (the mapping node's own sync drops,
    apart from the mailbox drops in ``drops``), ``errors`` and ``grid``
    are filled by :func:`run_online`.
    """

    published: int = 0
    bag_duration_s: float = 0.0
    wall_duration_s: float = 0.0
    rate: float = 1.0
    max_lag_s: float = 0.0  # how far publishing fell behind the timeline
    drops: Dict[str, int] = dataclasses.field(default_factory=dict)
    processed: Dict[str, int] = dataclasses.field(default_factory=dict)
    errors: Dict[str, int] = dataclasses.field(default_factory=dict)
    fused_frames: int = 0
    dropped_frames: int = 0
    grid: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    @property
    def dropped_total(self) -> int:
        return sum(self.drops.values())


def play_bag_timed(bag_path: str, bus: TopicBus, rate: float = 1.0, tf_tree=None,
                   topic_map: Optional[Dict[str, str]] = None) -> PlaybackReport:
    """Publish a bag onto the bus on its own timeline (``rosbag play -r``).

    Each record is published at ``wall_start + (stamp - stamp0) / rate``.
    Pair with :class:`NodeExecutor` subscribers so heavy work runs off the
    playback thread; overload then shows as mailbox drops, like the
    reference's online pipeline under a too-fast bag (ref README.md:190-196).
    """
    from .bag_adapter import play_bag_records

    pacer = _Pacer(rate)
    pacer.report.published = play_bag_records(bag_path, bus, tf_tree=tf_tree,
                                              topic_map=topic_map, pace=pacer)
    return pacer.finish()


class _Pacer:
    """Holds a bag's timeline on the wall clock: ``pacer(stamp)`` sleeps
    until ``wall_start + (stamp - stamp0) / rate`` and charges lateness to
    the report's ``max_lag_s``."""

    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.rate = rate
        self.report = PlaybackReport(rate=rate)
        self.wall0: Optional[float] = None
        self.stamp0: Optional[float] = None
        self.horizon: Optional[float] = None  # running max stamp: the timeline position

    def __call__(self, stamp: float) -> None:
        now = time.monotonic()
        if self.wall0 is None:
            self.wall0, self.stamp0, self.horizon = now, stamp, stamp
        if stamp <= self.horizon:
            # out-of-order record (bags interleave streams): publish at the
            # current timeline position, no sleep, no lag charged
            return
        self.horizon = stamp
        due = self.wall0 + (stamp - self.stamp0) / self.rate
        if due > now:
            time.sleep(due - now)
        else:
            self.report.max_lag_s = max(self.report.max_lag_s, now - due)

    def finish(self) -> PlaybackReport:
        r = self.report
        if self.wall0 is not None:
            r.bag_duration_s = self.horizon - self.stamp0
            r.wall_duration_s = time.monotonic() - self.wall0
        return r


def play_stream_timed(bag_path: str, bus: TopicBus, rate: float = 1.0,
                      image_topic: str = "/camera1/image_raw", pcd_topic: str = "/reduced_map",
                      pose_topic: str = "/current_pose", lookahead_s: float = 0.5,
                      max_buffered: int = 16, image_topics: Optional[Sequence[str]] = None,
                      with_tf: bool = False) -> PlaybackReport:
    """Timed playback with decode ahead: the streamed twin of :func:`play_bag_timed`.

    :func:`~.bag_adapter.stream_bag_frames` reads, decodes and syncs the bag
    on a worker thread into a bounded queue (``max_buffered`` frames), and
    this thread only publishes decoded frames on the bag's timeline: the
    decode of the next frames overlaps the nodes' work on this one.  If the
    decode cannot hold the timeline, the lateness shows in ``max_lag_s``.

    Each frame publishes its cloud (once per cloud, keyed on the cloud's
    stamp, at that stamp), its pose and its image (``/<camera>/image_raw``,
    one topic per camera of ``image_topics``).  With ``with_tf``, every
    ``/tf`` and ``/tf_static`` record is held until the timeline reaches
    its stamp and then published on ``/tf``, where a node's subscription
    folds it into its TF tree; the worker reads a record up to
    ``lookahead_s`` ahead of the frames that come before it, so publishing
    it as read would give those frames a later transform.  Frames are
    published after the sync: an image that finds no cloud and pose within
    ``lookahead_s`` is not published, and other topics are not surfaced.
    """
    from .bag_adapter import TFRecord, stream_bag_frames

    pacer = _Pacer(rate)
    report = pacer.report
    held: list = []  # (stamp, arrival, TFRecord) heap: /tf not yet due
    arrival = itertools.count()
    clouds_published: set = set()

    def publish_tf(upto: float) -> None:
        while held and held[0][0] <= upto:
            stamp, _, rec = heapq.heappop(held)
            pacer(stamp)
            bus.publish("/tf", rec.msg, stamp=stamp)
            report.published += 1

    for f in stream_bag_frames(bag_path, image_topic=image_topic, pcd_topic=pcd_topic,
                               pose_topic=pose_topic, lookahead_s=lookahead_s,
                               max_buffered=max_buffered, image_topics=image_topics,
                               with_tf=with_tf):
        if isinstance(f, TFRecord):
            heapq.heappush(held, (f.stamp, next(arrival), f))
            continue
        publish_tf(f.stamp)
        pacer(f.stamp)
        if f.pcd_stamp not in clouds_published:
            # clouds arrive ~1 Hz against a 12 Hz camera: each once, as
            # play_bag_timed publishes the cloud stream
            clouds_published.add(f.pcd_stamp)
            bus.publish(pcd_topic, f.pcd, stamp=f.pcd_stamp, frame_id=f.pcd_frame_id)
            report.published += 1
        bus.publish(pose_topic, (f.position, f.quaternion), stamp=f.stamp)
        bus.publish(f"/{f.camera}/image_raw", f.semantic_image, stamp=f.stamp, frame_id=f.camera)
        report.published += 2
    publish_tf(float("inf"))
    return pacer.finish()


def run_online(cfg, bag_path: str, rate: float = 1.0, predictor=None, engine=None,
               finalize: bool = True, fused: bool = False, pipeline=None,
               decode_ahead: bool = False, device: DeviceLike = "cuda") -> PlaybackReport:
    """Drive a bag through the online node topology at a wall-clock rate.

    The online twin of the reference's camera1_mapping.launch: the
    segmentation node and the mapping node each run on their own executor
    thread; camera frames use keep-latest mailboxes (depth 1), pose, cloud
    and tf topics history-deep ones feeding the node's sync queues.
    ``fused=True`` runs ONE :class:`~.node.FusedOnlineNode` instead (one
    fused step per frame).  ``predictor`` / ``engine`` / ``pipeline`` inject
    prebuilt SemanticSegmentation / SemanticMappingEngine /
    FusedFramePipeline instances (``pipeline`` only for the fused topology;
    a ``predictor``'s weights serve both).  ``decode_ahead=True`` feeds the
    nodes through :func:`play_stream_timed` (the bag decoded on a worker
    thread, every camera the nodes take and ``/tf``) instead of
    :func:`play_bag_timed`; that feed pairs each image with a cloud, so a
    planar node gets frames only from a bag that records clouds on
    ``/reduced_map``, as in the JAX package.  Returns a
    :class:`PlaybackReport` with per-topic drops, the frames fused and the
    final grid.
    """
    from ..utils.ros_compat import TransformTree
    from .bag_adapter import _camera_of_topic
    from .node import FusedOnlineNode, MappingNode, SegmentationNode

    bus = TopicBus()
    tf_tree = TransformTree()
    if fused:
        map_exec = NodeExecutor("fused")
        state_dict = predictor.model.state_dict() if predictor is not None else None
        mapping_node = FusedOnlineNode(cfg, bus, pipeline=pipeline, state_dict=state_dict,
                                       engine=engine, tf_tree=tf_tree, executor=map_exec,
                                       device=device)
        execs = [("fused", map_exec)]
    else:
        seg_exec = NodeExecutor("segmentation")
        map_exec = NodeExecutor("mapping")
        SegmentationNode(cfg, bus, predictor=predictor, executor=seg_exec, device=device)
        # seg publishes /<camera>/semantic on ITS thread into mapping's
        # mailbox: the forward of frame i+1 overlaps the fusion of frame i
        mapping_node = MappingNode(cfg, bus, engine=engine, tf_tree=tf_tree,
                                   executor=map_exec, device=device)
        execs = [("seg", seg_exec), ("map", map_exec)]

    try:
        if decode_ahead:
            report = play_stream_timed(
                bag_path, bus, rate=rate, pcd_topic=mapping_node.pcd_topic or "/reduced_map",
                image_topics=[f"/{_camera_of_topic(t)}/image_raw"
                              for t in mapping_node.IMAGE_TOPICS],
                with_tf=True)
        else:
            report = play_bag_timed(bag_path, bus, rate=rate)
        for _, ex in execs:
            ex.join()  # mapping drains frames published upstream while joining
    finally:
        for _, ex in execs:
            ex.stop()

    def by_executor(counts):
        return {f"{prefix}:{t}": n for prefix, ex in execs for t, n in getattr(ex, counts).items()
                if n or counts == "processed"}

    report.drops = by_executor("drops")
    report.processed = by_executor("processed")
    report.errors = by_executor("errors")
    # finalize unless the TEST_END_TIME cutoff already did (ref mapping.py:323)
    if finalize and mapping_node.grid is not None and mapping_node.finalized_map is None:
        mapping_node.finalize()
    report.fused_frames = mapping_node.fused_frames
    report.dropped_frames = mapping_node.dropped_frames
    report.grid = mapping_node.grid
    return report
