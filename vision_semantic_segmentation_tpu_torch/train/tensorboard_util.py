"""TensorBoard scalar logging for meter dicts.

Port of ``vision_semantic_segmentation_tpu/train/tensorboard_util.py`` (ref
core/utils/tensorboard_util.py:7-22): push every meter's global average
into a writer under a prefix.  The writer is any object with
``add_scalar(tag, value, step)`` (a tensorboardX ``SummaryWriter``, or
``torch.utils.tensorboard``'s).
"""
from __future__ import annotations

from .meters import MeterLogger


def add_scalars(writer, meter_logger: MeterLogger, prefix: str, global_step: int) -> None:
    for name, meter in meter_logger.meters.items():
        value = meter.global_avg
        if value == value:  # skip NaN
            writer.add_scalar(f"{prefix}/{name}", value, global_step)
