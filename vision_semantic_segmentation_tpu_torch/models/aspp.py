"""Atrous Spatial Pyramid Pooling.

Port of ``vision_semantic_segmentation_tpu/models/aspp.py`` (ref
aspp.py:11-103): a plain conv branch, k-1 depthwise-separable atrous
branches (their depthwise 3x3s run K3), and a global average-pool branch
upsampled with align_corners=True; concatenated, then fused by a 1x1 conv +
dropout.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvBNReLU, DepthwiseSeparableConv
from .resize import resize_nchw


class ASPP(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int = 256,
        atrous_channels: Sequence[int] = (256, 256, 256, 256),
        atrous_kernel_size: Sequence[int] = (1, 3, 3, 3),
        atrous_dilation: Sequence[int] = (1, 6, 12, 18),
        dropout: float = 0.5,
    ):
        super().__init__()
        if not len(atrous_channels) == len(atrous_kernel_size) == len(atrous_dilation):
            raise ValueError("ASPP branch lists differ in length")
        # padding keeps each branch at the input spatial size
        # (ref aspp.py:45-49: pad 0 when dilation 1 else pad = dilation)
        branches = []
        for i, (ch, k, d) in enumerate(zip(atrous_channels, atrous_kernel_size, atrous_dilation)):
            pad = 0 if d == 1 else d
            cls = ConvBNReLU if i == 0 else DepthwiseSeparableConv
            kw = dict(bn=True, relu=True) if i == 0 else dict(
                depthwise_bn=True, pointwise_bn=True, depthwise_relu=True, pointwise_relu=True
            )
            branches.append(cls(in_channels, ch, k, dilation=d, padding=pad, **kw))
        self.module_pyramid = nn.ModuleList(branches)
        # image-pooling branch (ref aspp.py:66-70,86-88): index 0 is the
        # parameter-free pool, as in the reference's Sequential
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            ConvBNReLU(in_channels, 256, 1, bn=True, relu=True),
        )
        self.conv = ConvBNReLU(sum(atrous_channels) + 256, out_channels, 1, bn=True, relu=True)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [branch(x) for branch in self.module_pyramid]
        pooled = self.global_avg_pool(x)
        outs.append(resize_nchw(pooled, tuple(outs[0].shape[-2:])))
        return self.dropout(self.conv(torch.cat(outs, dim=1)))
