from .bus import Message, TopicBus, nearest_stamp_index
from .io import FrameRecord, load_frames, save_frames
from .node import FusedOnlineNode, MappingNode, SegmentationNode
from .pipeline import FusedFramePipeline, network_to_channel_table
from .replay import MappingReplay, write_png

__all__ = [
    "Message",
    "TopicBus",
    "nearest_stamp_index",
    "FrameRecord",
    "load_frames",
    "save_frames",
    "FusedOnlineNode",
    "MappingNode",
    "SegmentationNode",
    "FusedFramePipeline",
    "network_to_channel_table",
    "MappingReplay",
    "write_png",
]
