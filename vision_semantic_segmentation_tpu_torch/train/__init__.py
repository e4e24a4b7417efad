"""Training (port of ``vision_semantic_segmentation_tpu/train/``)."""
from .build import build_dataloader, build_transform
from .checkpoint import Checkpoint
from .freezer import bn_parameter_names, frozen_parameter_names, trainable_parameters
from .meters import AverageMeter, GenericMetric, MeterLogger
from .optim import (
    build_optimizer,
    build_schedule,
    build_scheduler,
    multi_step_lr,
    polynomial_lr_decay,
    step_lr,
)
from .trainer import Trainer, train

__all__ = [
    "build_dataloader",
    "build_transform",
    "Checkpoint",
    "bn_parameter_names",
    "frozen_parameter_names",
    "trainable_parameters",
    "AverageMeter",
    "GenericMetric",
    "MeterLogger",
    "build_optimizer",
    "build_schedule",
    "build_scheduler",
    "multi_step_lr",
    "polynomial_lr_decay",
    "step_lr",
    "Trainer",
    "train",
]
