from .io import FrameRecord, load_frames, save_frames
from .pipeline import FusedFramePipeline, network_to_channel_table
from .replay import MappingReplay, write_png

__all__ = [
    "FrameRecord",
    "load_frames",
    "save_frames",
    "FusedFramePipeline",
    "network_to_channel_table",
    "MappingReplay",
    "write_png",
]
