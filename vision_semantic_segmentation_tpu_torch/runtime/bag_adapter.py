"""Rosbag -> topic-bus playback adapter.

The reference's launch files wire `rosbag play` into the two nodes over
TCPROS (ref scripts/launch/camera1_mapping.launch:6-15).
This adapter replays a ``.bag`` file onto the in-process :class:`TopicBus`
in record order, translating message payloads into the pipeline's native
types:

  * ``sensor_msgs/Image`` / ``CompressedImage``  -> uint8 RGB array on
    ``/<camera>/image_raw``
  * ``sensor_msgs/PointCloud2``                  -> (4, N) float32 xyzi
  * ``geometry_msgs/PoseStamped``                -> (position, quaternion)
  * ``tf2_msgs/TFMessage`` / ``tf/tfMessage``    -> TransformTree updates
    (feeding the dynamic camera-extrinsics path, ref mapping.py:142-163)

Message stamps prefer the ROS header stamp (what the reference's
nearest-stamp sync keys on) and fall back to the bag record time.

Port of ``vision_semantic_segmentation_tpu/runtime/bag_adapter.py`` over
the port's own :mod:`.rosbag`.  Host numpy throughout: the nodes and the
replay move what they consume to their device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .bus import TopicBus
from .rosbag import (
    CompressedImageMsg,
    ImageMsg,
    PointCloud2Msg,
    PoseStampedMsg,
    RosbagReader,
    TFMessageMsg,
)

__all__ = [
    "play_bag", "play_bag_records", "bag_to_frames", "stream_bag_frames",
    "TFRecord", "DEFAULT_TOPIC_MAP",
]


class _ConsumerGone(BaseException):
    """The stream_bag_frames consumer abandoned the generator."""


class TFRecord:
    """A /tf (tf2_msgs/TFMessage) record surfaced by stream_bag_frames.

    Emitted as soon as the worker reads it: never after the frames stamped
    after it, but possibly up to ``lookahead_s`` before frames stamped
    before it, which the worker still holds for their sync.  A consumer
    that applies transforms on the bag's timeline holds each record until
    then, as :func:`~.async_bus.play_stream_timed` does."""

    __slots__ = ("stamp", "msg")

    def __init__(self, stamp: float, msg):
        self.stamp = stamp
        self.msg = msg

# The reference's launch files republish the AVT camera topics to
# /<camera>/image_raw (ref scripts/launch/camera1_mapping.launch:13-15);
# these renames replace that image_transport republisher.
DEFAULT_TOPIC_MAP = {
    "/avt_cameras/camera1/image_color": "/camera1/image_raw",
    "/avt_cameras/camera1/image_color/compressed": "/camera1/image_raw",
    "/avt_cameras/camera6/image_color": "/camera6/image_raw",
    "/avt_cameras/camera6/image_color/compressed": "/camera6/image_raw",
}


def _camera_of_topic(topic: str) -> str:
    """'/camera1/image_raw' -> 'camera1' (launch-file topic convention)."""
    parts = [p for p in topic.split("/") if p]
    return parts[0] if parts else "camera1"


def play_bag(
    bag_path: str,
    bus: TopicBus,
    tf_tree=None,
    topic_map: Optional[Dict[str, str]] = None,
) -> int:
    """Publish every supported message of a bag onto the bus, in order.

    Args:
        tf_tree: optional TransformTree updated from /tf and /tf_static.
        topic_map: optional bag-topic -> bus-topic renames (e.g.
            ``{"/ndt_pose": "/current_pose"}``).

    Returns the number of messages published.  For playback on the bag's
    own timeline (``rosbag play -r``) see
    :func:`~.async_bus.play_bag_timed`.
    """
    return play_bag_records(bag_path, bus, tf_tree=tf_tree, topic_map=topic_map)


def play_bag_records(
    bag_path: str,
    bus: TopicBus,
    tf_tree=None,
    topic_map: Optional[Dict[str, str]] = None,
    pace=None,
) -> int:
    """:func:`play_bag` core with an optional ``pace(stamp)`` hook called
    before each publish — the timed player uses it to hold the bag's
    timeline (sleeping keeps this thread cheap; heavy subscribers should
    run behind NodeExecutor mailboxes so lateness surfaces as drops)."""
    topic_map = {**DEFAULT_TOPIC_MAP, **(topic_map or {})}
    count = 0
    # image_transport records often carry BOTH the raw and compressed
    # variants of one camera stream; when several source topics rename onto
    # one bus topic, the first seen owns it (no double-publishing frames)
    owner: Dict[str, str] = {}
    for rec in RosbagReader(bag_path).read_messages():
        topic = topic_map.get(rec.topic, rec.topic)
        if topic != rec.topic and owner.setdefault(topic, rec.topic) != rec.topic:
            continue
        if pace is not None:
            pace(rec.stamp)
        msg = rec.message
        if isinstance(msg, TFMessageMsg):
            if tf_tree is not None:
                for tr in msg.transforms:
                    tf_tree.set_pose(
                        tr.translation, tr.rotation,
                        parent=tr.header.frame_id.lstrip("/"),
                        child=tr.child_frame_id.lstrip("/"),
                        stamp=tr.header.stamp,
                    )
            # also surface on the bus for subscribers (e.g. node TF refresh)
            bus.publish("/tf", msg, stamp=rec.stamp)
            count += 1
        elif isinstance(msg, (ImageMsg, CompressedImageMsg)):
            stamp = msg.header.stamp or rec.stamp
            bus.publish(
                topic, msg.rgb(), stamp=stamp,
                frame_id=msg.header.frame_id.lstrip("/") or _camera_of_topic(topic),
            )
            count += 1
        elif isinstance(msg, PointCloud2Msg):
            stamp = msg.header.stamp or rec.stamp
            bus.publish(
                topic, msg.xyzi(), stamp=stamp,
                frame_id=msg.header.frame_id.lstrip("/"),
            )
            count += 1
        elif isinstance(msg, PoseStampedMsg):
            stamp = msg.header.stamp or rec.stamp
            bus.publish(
                topic, (msg.position, msg.quaternion), stamp=stamp,
                frame_id=msg.header.frame_id.lstrip("/"),
            )
            count += 1
    return count


def stream_bag_frames(
    bag_path: str,
    image_topic: str = "/camera1/image_raw",
    pcd_topic: str = "/reduced_map",
    pose_topic: str = "/current_pose",
    lookahead_s: float = 0.5,
    max_buffered: int = 16,
    image_topics: Optional[Sequence[str]] = None,
    with_tf: bool = False,
):
    """Stream synced FrameRecords from a bag, decoding on a worker thread.

    The one-pass streaming twin of :func:`bag_to_frames`: a background
    thread reads + deserializes bag records (image decode, PointCloud2
    unpack) and emits FrameRecords through a bounded queue, so the
    consumer — typically the fused device pipeline — overlaps host decode
    of the NEXT frames with device compute on the current ones.  The
    queue bound (``max_buffered`` frames) provides backpressure: a long
    bag never materializes in RAM.

    Sync semantics match :func:`bag_to_frames`'s true nearest-stamp
    pairing provided the bag is time-ordered within ``lookahead_s``
    (an image is held until a cloud AND a pose with stamps past
    ``image_stamp + lookahead_s`` have been seen, then paired with the
    nearest of each).

    ``image_topics`` streams SEVERAL cameras through one pass — each
    FrameRecord carries its own ``camera``, frames interleave in stamp
    order (the dual-camera path, ref mapping.py:528-541); it overrides
    ``image_topic`` when given.  ``with_tf=True`` additionally yields
    :class:`TFRecord` items for ``/tf`` / ``/tf_static`` messages,
    feeding the dynamic camera-extrinsics path (ref mapping.py:142-163).

    Yields FrameRecord (and TFRecord when enabled).  The worker dies
    with the consumer (daemon + generator close), and reader errors
    re-raise at the consumption site.
    """
    import queue as _queue
    import threading

    from .io import FrameRecord

    img_topics = tuple(image_topics) if image_topics else (image_topic,)
    tf_topics = ("/tf", "/tf_static") if with_tf else ()
    wanted = {*img_topics, pcd_topic, pose_topic, *tf_topics}
    aliases = {t: v for t, v in DEFAULT_TOPIC_MAP.items() if v in wanted}
    camera_of = {t: _camera_of_topic(t) for t in img_topics}
    out: "_queue.Queue" = _queue.Queue(maxsize=max(1, int(max_buffered)))
    _DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone.

        Without this, a consumer that abandons the generator early (error
        mid-replay, break) leaves the decoder thread blocked forever in
        ``out.put`` holding the open bag reader plus ``max_buffered``
        decoded frames (same fix as train/prefetch.py).
        """
        while not stop.is_set():
            try:
                out.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def nearest(entries, target):
        return min(entries, key=lambda e: abs(e[0] - target))

    def worker():
        owner: Dict[str, str] = {}
        images, clouds, poses = [], [], []
        # nearest() returns the same cloud for many consecutive frames
        # (clouds arrive ~1 Hz vs a 12 Hz camera): unpack each PointCloud2
        # once, not once per paired frame.  Two entries keyed on the
        # cloud's stamp, so frames of two cameras that interleave between
        # two clouds do not unpack them again on every frame
        memo: Dict[float, tuple] = {}

        def cloud_xyzi(stamp, cloud):
            hit = memo.get(stamp)
            if hit is None or hit[0] is not cloud:
                if len(memo) >= 2:
                    del memo[next(iter(memo))]
                hit = memo[stamp] = (cloud, cloud.xyzi())
            return hit[1]

        def flush(horizon: Optional[float]) -> None:
            """Emit images whose lookahead window is fully covered (or
            everything at EOF when horizon is None)."""
            while images:
                stamp, img, cam = images[0]
                if horizon is not None and (
                    not clouds or clouds[-1][0] < stamp + lookahead_s
                    or not poses or poses[-1][0] < stamp + lookahead_s
                ):
                    return
                if not clouds or not poses:  # EOF with nothing to pair
                    return
                images.pop(0)
                cloud_stamp, cloud = nearest(clouds, stamp)
                pose = nearest(poses, stamp)[1]
                if not put(FrameRecord(
                    pcd=cloud_xyzi(cloud_stamp, cloud),
                    pcd_frame_id=cloud.header.frame_id.lstrip("/") or "world",
                    semantic_image=img.rgb(),
                    position=np.asarray(pose.position),
                    quaternion=np.asarray(pose.quaternion),
                    camera=cam,
                    stamp=stamp,
                    pcd_stamp=cloud_stamp,
                )):
                    raise _ConsumerGone
                # prune history no future image (stamp >= this one, modulo
                # lookahead disorder) can pair nearer than its keepers
                cut = stamp - lookahead_s
                while len(clouds) > 1 and clouds[1][0] < cut:
                    clouds.pop(0)
                while len(poses) > 1 and poses[1][0] < cut:
                    poses.pop(0)

        try:
            for rec in RosbagReader(bag_path).read_messages(
                topics=list(wanted) + list(aliases)
            ):
                target = aliases.get(rec.topic, rec.topic)
                if rec.topic != target and owner.setdefault(target, rec.topic) != rec.topic:
                    continue
                msg = rec.message
                stamp = getattr(msg, "header", None)
                stamp = (stamp.stamp if stamp else 0.0) or rec.stamp
                if target in camera_of and isinstance(
                    msg, (ImageMsg, CompressedImageMsg)
                ):
                    images.append((stamp, msg, camera_of[target]))
                elif target == pcd_topic and isinstance(msg, PointCloud2Msg):
                    clouds.append((stamp, msg))
                elif target == pose_topic and isinstance(msg, PoseStampedMsg):
                    poses.append((stamp, msg))
                elif with_tf and isinstance(msg, TFMessageMsg):
                    if not put(TFRecord(stamp, msg)):
                        raise _ConsumerGone
                flush(horizon=stamp)
            flush(horizon=None)
            put(_DONE)
        except _ConsumerGone:
            return
        except BaseException as exc:  # surface reader errors to the consumer
            put(exc)

    thread = threading.Thread(target=worker, name="bag-decoder", daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # early exit (break / exception / GeneratorExit): release a
        # producer blocked on the full queue and reap the thread
        stop.set()
        while True:
            try:
                out.get_nowait()
            except _queue.Empty:
                break
        thread.join(timeout=5.0)


def bag_to_frames(
    bag_path: str,
    image_topic: str = "/camera1/image_raw",
    pcd_topic: str = "/reduced_map",
    pose_topic: str = "/current_pose",
):
    """Convert a bag into replayable FrameRecords (nearest-stamp sync).

    Host-side equivalent of the mapping node's queue sync for exporting
    bags to the ``.npz`` replay format: each image frame is paired with the
    nearest pose and the nearest cloud by header stamp.  True
    nearest-neighbor selection is used here (the node's
    ``nearest_stamp_index`` mirrors the reference's queue-walk, ref
    mapping.py:185-219, whose bracketing test skips exact-equal stamps and
    falls through to the newest entry — correct for its consume-as-you-go
    queues, wrong for a full recorded timeline).
    """
    from .io import FrameRecord

    def nearest(stamps: np.ndarray, target: float) -> int:
        return int(np.argmin(np.abs(stamps - target)))

    wanted = {image_topic, pcd_topic, pose_topic}
    # accept bag topics that the default republisher renames map onto,
    # but let only ONE source per bus topic contribute (raw + compressed
    # variants of the same stream would otherwise duplicate every frame)
    aliases = {t: v for t, v in DEFAULT_TOPIC_MAP.items() if v in wanted}
    owner: dict = {}
    images, clouds, poses = [], [], []
    for rec in RosbagReader(bag_path).read_messages(
        topics=list(wanted) + list(aliases)
    ):
        target = aliases.get(rec.topic, rec.topic)
        if rec.topic != target and owner.setdefault(target, rec.topic) != rec.topic:
            continue
        msg = rec.message
        if isinstance(msg, (ImageMsg, CompressedImageMsg)):
            images.append((msg.header.stamp or rec.stamp, msg))
        elif isinstance(msg, PointCloud2Msg):
            clouds.append((msg.header.stamp or rec.stamp, msg))
        elif isinstance(msg, PoseStampedMsg):
            poses.append((msg.header.stamp or rec.stamp, msg))

    if not images or not clouds or not poses:
        raise ValueError(
            f"{bag_path}: need images ({len(images)}), clouds "
            f"({len(clouds)}) and poses ({len(poses)}) to build frames"
        )
    cloud_stamps = np.array([s for s, _ in clouds])
    pose_stamps = np.array([s for s, _ in poses])
    frames = []
    # derive the camera id from the BUS-side topic so AVT source names
    # (e.g. /avt_cameras/camera1/image_color) still yield 'camera1'
    camera = _camera_of_topic(DEFAULT_TOPIC_MAP.get(image_topic, image_topic))
    for stamp, img in images:
        cloud = clouds[nearest(cloud_stamps, stamp)][1]
        pose = poses[nearest(pose_stamps, stamp)][1]
        frames.append(
            FrameRecord(
                pcd=cloud.xyzi(),
                pcd_frame_id=cloud.header.frame_id.lstrip("/") or "world",
                semantic_image=img.rgb(),
                position=np.asarray(pose.position),
                quaternion=np.asarray(pose.quaternion),
                camera=camera,
                stamp=stamp,
            )
        )
    return frames
