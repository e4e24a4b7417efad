"""Atrous Spatial Pyramid Pooling.

Port of ``vision_semantic_segmentation_tpu/models/aspp.py`` (ref
aspp.py:11-103): a plain conv branch, k-1 depthwise-separable atrous
branches, and a global average-pool branch upsampled with
align_corners=True; concatenated, then fused by a 1x1 conv + dropout.

The atrous branches' depthwise 3x3s all read the same input, so they run
first, together: two or more as one K4 call, a single one as K3 (see
``layers.depthwise_convs``); a branch whose depthwise conv does not fit
the kernels runs ``F.conv2d`` inside its own module.  Each branch then goes
on through its own BatchNorm, ReLU and pointwise conv.  Module and
parameter names are the reference's, so state dicts load ``strict=True``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import ConvBNReLU, DepthwiseSeparableConv, depthwise_convs
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

    def fused_branches(self) -> list:
        """Indices of the branches whose depthwise conv runs through K3/K4."""
        return [
            i for i, b in enumerate(self.module_pyramid)
            if isinstance(b, DepthwiseSeparableConv) and b.depthwise_cnn.conv.uses_k3()
        ]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = self.fused_branches()
        depthwise = {}
        if fused:
            convs = [self.module_pyramid[i].depthwise_cnn.conv for i in fused]
            depthwise = dict(zip(fused, depthwise_convs(convs, x)))
        outs = [
            branch.finish(depthwise[i]) if i in depthwise else branch(x)
            for i, branch in enumerate(self.module_pyramid)
        ]
        pooled = self.global_avg_pool(x)
        outs.append(resize_nchw(pooled, tuple(outs[0].shape[-2:])))
        return self.dropout(self.conv(torch.cat(outs, dim=1)))
