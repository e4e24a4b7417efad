from .bus import Message, TopicBus, nearest_stamp_index
from .io import (
    FrameRecord,
    iter_sequence_files,
    load_frames,
    load_reference_dump,
    save_frames,
)
from .node import FusedOnlineNode, MappingNode, SegmentationNode
from .pipeline import FusedFramePipeline, network_to_channel_table
from .replay import MappingReplay, write_png
from .video import generate_video

__all__ = [
    "Message",
    "TopicBus",
    "nearest_stamp_index",
    "FrameRecord",
    "iter_sequence_files",
    "load_frames",
    "load_reference_dump",
    "save_frames",
    "FusedOnlineNode",
    "MappingNode",
    "SegmentationNode",
    "FusedFramePipeline",
    "network_to_channel_table",
    "MappingReplay",
    "generate_video",
    "write_png",
]
