"""Model registry (ref models/build.py:57-72).

Port of ``vision_semantic_segmentation_tpu/models/build.py``: DeepLabV3+,
Xception (Xception65 and a 1x1 classifier) and the Dummy model.
``build_model`` returns the network
alone, in eval mode, on ``device`` (CUDA unless the caller asks for the
CPU), in ``dtype`` and channels-last memory, for the serving paths.
``build_train_model`` returns ``(model, loss_fn, train_metric,
val_metric)`` as the JAX registry does, the model in f32 and in training
mode (``TRAIN.REMAT_BACKBONE`` recomputes each backbone block in the
backward pass).  Weights are drawn from ``generator`` (He-normal fan-out
convs, identity BatchNorm — the JAX package's initialisers), or load
afterwards with ``load_state_dict(strict=True)`` (see
``models/convert.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .deeplab import deeplab_from_cfg
from .loss import CrossEntropyLoss
from .metrics import MeanIOU
from .resize import resize_nchw
from .xception import Xception65


class Dummy(nn.Module):
    """Tiny stand-in model (ref models/build.py:27-54) for pipeline tests.

    ``Conv.0`` / ``Conv.1`` are the flax auto-names ``Conv_0`` / ``Conv_1``.
    """

    def __init__(self, num_classes: int):
        super().__init__()
        self.Conv = nn.ModuleList([nn.Conv2d(3, 32, 3, padding=1), nn.Conv2d(32, num_classes, 1)])

    def forward(self, x: torch.Tensor, upsample_pred: bool = True) -> torch.Tensor:
        y = self.Conv[1](F.relu(self.Conv[0](x)))
        if upsample_pred:
            y = resize_nchw(y, x.shape[-2:])
        return y


class XceptionSeg(nn.Module):
    """Xception65 feature extractor + 1x1 classifier (JAX ``build_xception``).

    The reference declares this builder and leaves it unimplemented (ref
    models/build.py:9-10); the JAX package wires its Xception65 into this
    minimal head, and so does the port.  With ``upsample_pred`` the logits
    are resized to the input in f32 (align corners).  The JAX head computes
    in f32 whatever dtype it is built for (its modules take no dtype); the
    port's follows ``build_model``'s ``dtype`` like every other network.
    """

    def __init__(self, num_classes: int, output_stride: int = 16, remat: bool = False):
        super().__init__()
        self.backbone = Xception65(output_stride=output_stride, remat=remat)
        self.classifier = nn.Conv2d(Xception65.out_channels, num_classes, 1)

    def forward(self, x: torch.Tensor, upsample_pred: bool = True) -> torch.Tensor:
        logits = self.classifier(self.backbone(x)["feature"])
        if upsample_pred:
            logits = resize_nchw(logits.float(), x.shape[-2:])
        return logits


def build_xception(cfg) -> XceptionSeg:
    """``XceptionSeg`` of a network config node (``TRAIN.REMAT_BACKBONE``
    exists only in the train tree)."""
    return XceptionSeg(
        cfg.DATASET.NUM_CLASSES, output_stride=cfg.MODEL.OUTPUT_STRIDE,
        remat=bool(getattr(getattr(cfg, "TRAIN", None), "REMAT_BACKBONE", False)),
    )


_MODEL_BUILDERS = {
    "Xception": build_xception,
    "DeepLabv3+": deeplab_from_cfg,
    "Dummy": lambda cfg: Dummy(cfg.DATASET.NUM_CLASSES),
}


def init_weights_(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """He-normal (fan-out, ReLU) conv kernels, zero biases, identity BatchNorm."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def build_model(
    cfg,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build ``cfg.MODEL.TYPE`` (a network config node) ready for inference."""
    if cfg.MODEL.TYPE not in _MODEL_BUILDERS:
        raise KeyError(f"Unknown MODEL.TYPE {cfg.MODEL.TYPE!r}")
    dev = resolve_device(device)
    model = init_weights_(_MODEL_BUILDERS[cfg.MODEL.TYPE](cfg), generator)
    return model.to(device=dev, dtype=dtype, memory_format=torch.channels_last).eval()


def build_train_model(
    cfg,
    device: DeviceLike = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Tuple[nn.Module, CrossEntropyLoss, MeanIOU, MeanIOU]:
    """``(model, loss_fn, train_metric, val_metric)`` for ``cfg.MODEL.TYPE``
    (a train config tree): the model in f32 and training mode, on
    ``device`` in channels-last memory; the loss ignores label 255."""
    model = build_model(cfg, dtype=torch.float32, device=device, generator=generator).train()
    num_classes = cfg.DATASET.NUM_CLASSES
    return model, CrossEntropyLoss(ignore_index=255), MeanIOU(num_classes), MeanIOU(num_classes)
