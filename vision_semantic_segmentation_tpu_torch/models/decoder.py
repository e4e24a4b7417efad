"""DeepLabV3+ decoder.

Port of ``vision_semantic_segmentation_tpu/models/decoder.py`` (ref
decoder.py:9-57): reduce the low-level feature with a 1x1 conv, upsample
the ASPP output to its size (align_corners=True), concatenate, refine with
depthwise-separable convs and classify with a 1x1 conv.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvBNReLU, DepthwiseSeparableConv
from .resize import resize_nchw


class Decoder(nn.Module):
    def __init__(
        self,
        in_channels: int,
        low_level_in_channels: int,
        out_channels: int,
        low_level_out_channels: int = 48,
        refine_channels: Sequence[int] = (256, 256),
        refine_kernel_size: Sequence[int] = (3, 3),
    ):
        super().__init__()
        if len(refine_channels) != len(refine_kernel_size):
            raise ValueError("refine channel/kernel lists differ in length")
        self.low_level_conv = ConvBNReLU(
            low_level_in_channels, low_level_out_channels, 1, bn=True, relu=True
        )
        # NOTE: the reference's refine convs use the torch default padding=0,
        # so each 3x3 shrinks the map by 2 pixels (ref decoder.py:33-37).
        # The logits are (H/4 - 4, W/4 - 4); the engine's gather depends on it.
        layers = []
        ch_in = in_channels + low_level_out_channels
        for ch, k in zip(refine_channels, refine_kernel_size):
            layers.append(DepthwiseSeparableConv(
                ch_in, ch, k, depthwise_bn=True, pointwise_bn=True,
                depthwise_relu=True, pointwise_relu=True,
            ))
            ch_in = ch
        layers.append(ConvBNReLU(ch_in, out_channels, 1))
        self.refine_layers = nn.ModuleList(layers)

    def forward(self, feature: torch.Tensor, low_level_feature: torch.Tensor) -> torch.Tensor:
        low = self.low_level_conv(low_level_feature)
        feature = resize_nchw(feature, low.shape[-2:])
        x = torch.cat([feature, low], dim=1)
        for layer in self.refine_layers:
            x = layer(x)
        return x
