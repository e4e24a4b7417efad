"""DeepLabV3+ segmentation model.

Port of ``vision_semantic_segmentation_tpu/models/deeplab.py`` (ref
deeplab_v3_plus.py:10-71): backbone -> ASPP -> decoder, with the atrous
dilations widened for output stride 8 ((1, 12, 24, 36)) vs 16
((1, 6, 12, 18)), and optional align_corners=True upsampling of the
logits to the input size.

The backbone is a ResNet of ``resnet.build_backbone`` or, as
``"xception65"``, the modified aligned Xception-65 of the DeepLabV3+ paper
(arXiv:1802.02611, section 4.2) at output stride 16 with its exit convs at
rate 2 (``xception.Xception65``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .aspp import ASPP
from .decoder import Decoder
from .resize import resize_nchw
from .resnet import build_backbone
from .xception import Xception65


class DeepLabV3Plus(nn.Module):
    def __init__(
        self,
        out_channels: int,
        backbone: str = "resnext50_32x4d",
        output_stride: int = 8,
        aspp_out_channels: int = 256,
        aspp_atrous_channels: Sequence[int] = (256, 256, 256, 256),
        aspp_atrous_kernel_size: Sequence[int] = (1, 3, 3, 3),
        aspp_dropout: float = 0.5,
        decoder_low_level_out_channels: int = 48,
        decoder_refine_channels: Sequence[int] = (256, 256),
        decoder_refine_kernel_size: Sequence[int] = (3, 3),
        remat_backbone: bool = False,
    ):
        super().__init__()
        dilations = {16: (1, 6, 12, 18), 8: (1, 12, 24, 36)}.get(output_stride)
        if dilations is None:
            raise NotImplementedError(f"output_stride {output_stride}")
        if backbone == "xception65":
            self.backbone = Xception65(output_stride, remat=remat_backbone, exit_rate=2)
        else:
            self.backbone = build_backbone(backbone, output_stride, remat=remat_backbone)
        self.aspp = ASPP(
            self.backbone.out_channels, aspp_out_channels, aspp_atrous_channels,
            aspp_atrous_kernel_size, dilations, aspp_dropout,
        )
        self.decoder = Decoder(
            aspp_out_channels, self.backbone.low_level_channels, out_channels,
            decoder_low_level_out_channels, decoder_refine_channels,
            decoder_refine_kernel_size,
        )

    def forward(self, x: torch.Tensor, upsample_pred: bool = True) -> torch.Tensor:
        """(N, 3, H, W) normalized images -> (N, out_channels, H', W') logits."""
        features = self.backbone(x)
        feature = self.aspp(features["feature"])
        logits = self.decoder(feature, features["low_feature"])
        if upsample_pred:
            logits = resize_nchw(logits.float(), x.shape[-2:])
        return logits


def deeplab_from_cfg(cfg) -> DeepLabV3Plus:
    """Construct the model from a network config node (demo or train tree).

    ``TRAIN.REMAT_BACKBONE`` exists only in the train tree; the demo tree
    never remats."""
    backbone = cfg.MODEL.BACKBONE
    if backbone == "resnet":  # reference's deeplab default alias
        backbone = "resnet50"
    return DeepLabV3Plus(
        out_channels=cfg.DATASET.NUM_CLASSES,
        backbone=backbone,
        output_stride=cfg.MODEL.OUTPUT_STRIDE,
        aspp_out_channels=cfg.MODEL.ASPP.OUT_CHANNELS,
        aspp_atrous_channels=tuple(cfg.MODEL.ASPP.ATROUS_CHANNELS),
        aspp_atrous_kernel_size=tuple(cfg.MODEL.ASPP.ATROUS_KERNEL_SIZE),
        aspp_dropout=cfg.MODEL.ASPP.DROPOUT,
        decoder_low_level_out_channels=cfg.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS,
        decoder_refine_channels=tuple(cfg.MODEL.DECODER.REFINE_CHANNELS),
        decoder_refine_kernel_size=tuple(cfg.MODEL.DECODER.REFINE_KERNEL_SIZE),
        remat_backbone=bool(getattr(getattr(cfg, "TRAIN", None), "REMAT_BACKBONE", False)),
    )
