"""In-process topic bus: the ROS pub/sub replacement.

Own copy of ``vision_semantic_segmentation_tpu/runtime/bus.py``.  The
reference couples its two nodes through ROS topics over TCPROS (the
segmentation node publishes /cameraX/semantic, the mapping node subscribes;
camera1_mapping.launch:6-9).  Here both stages live in one process and talk
through this synchronous bus: callbacks run inline on publish, in
subscription order; queues and nearest-stamp sync live in the nodes.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class Message:
    """A stamped topic message (the ROS header fields in use)."""

    data: Any
    stamp: float = 0.0
    frame_id: str = ""


class TopicBus:
    def __init__(self):
        self._subscribers: Dict[str, List[Callable[[Message], None]]] = defaultdict(list)
        self.published_counts: Dict[str, int] = defaultdict(int)

    def subscribe(self, topic: str, callback: Callable[[Message], None]) -> None:
        self._subscribers[topic].append(callback)

    def publish(self, topic: str, data: Any, stamp: float = 0.0, frame_id: str = "") -> None:
        msg = Message(data=data, stamp=stamp, frame_id=frame_id)
        self.published_counts[topic] += 1
        for callback in self._subscribers[topic]:
            callback(msg)


def nearest_stamp_index(stamps: List[float], target: float) -> int:
    """Nearest-neighbour time sync over a sorted stamp queue.

    The selection rule of ref mapping.py:185-219 / :238-259: find the
    bracketing pair around ``target`` and pick the closer one (ties -> the
    earlier); if every stamp is below target, pick the last.
    """
    for i in range(len(stamps) - 1):
        if stamps[i + 1] > target:
            if stamps[i] < target:
                diff_hi = stamps[i + 1] - target
                diff_lo = target - stamps[i]
                return i + 1 if diff_lo > diff_hi else i
    return len(stamps) - 1
