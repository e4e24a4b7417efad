"""Conv building blocks for the segmentation model family.

Port of ``vision_semantic_segmentation_tpu/models/layers.py``: a Conv2d with
optional BatchNorm/ReLU (bias off when BN is on), TF-style "same" padding,
and a depthwise-separable variant (ref core/nn/modules/conv.py:48-146).
Modules are NCHW ``nn.Module``s with the reference torch parameter names
(``conv``, ``bn``, ``depthwise_cnn``, ``pointwise_cnn``), so a reference
state dict loads with ``strict=True``.  Run them in ``channels_last``
memory: cuDNN prefers it, and K3/K4 then read the activation as NHWC without
a copy.

Depthwise 3x3 convs with stride 1 and padding == dilation (ASPP's atrous
branches) run through K3 (``ops/kernels/depthwise.py``), or several of them
over one input through K4 (:func:`depthwise_convs`); other depthwise convs
(the decoder's unpadded refine convs) and grouped convs are plain
``F.conv2d``, as the JAX package runs them outside any Pallas kernel.  The
TPU-only block-diagonal and tile-diagonal grouped forms are not ported.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.depthwise import aspp_depthwise3x3_multi, depthwise3x3_dilated

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_padding(kernel_size: IntPair, stride: IntPair, dilation: IntPair):
    """TF "SAME" padding amounts, matching the reference's formula.

    ``pad_total = dilation*k - dilation + 1 - stride`` clipped at zero, split
    with the extra pixel on the bottom/right (ref conv.py:6-41).
    Returns ((top, bottom), (left, right)).
    """
    k = np.array(_pair(kernel_size))
    s = np.array(_pair(stride))
    d = np.array(_pair(dilation))
    total = np.clip(d * k - d + 1 - s, 0, None)
    lo = total // 2
    hi = total - lo
    return ((int(lo[0]), int(hi[0])), (int(lo[1]), int(hi[1])))


class DepthwiseConv2d(nn.Conv2d):
    """Depthwise ``nn.Conv2d`` (groups == channels) that runs K3 where it applies."""

    def uses_k3(self) -> bool:
        d = self.dilation[0]
        return (
            self.kernel_size == (3, 3)
            and self.stride == (1, 1)
            and self.dilation == (d, d)
            and self.padding == (d, d)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.uses_k3():
            return super().forward(x)
        return depthwise_convs([self], x)[0]


def depthwise_convs(convs: Sequence[DepthwiseConv2d], x: torch.Tensor) -> List[torch.Tensor]:
    """Several depthwise convs that pass ``uses_k3`` over one NCHW
    (channels-last) input.

    One conv runs K3; two or more run as one K4 call per frame, which reads
    ``x`` once for all of them.  Returns one NCHW output per conv.
    """
    kernels = [c.weight.permute(2, 3, 1, 0) for c in convs]  # (C, 1, 3, 3) -> (3, 3, 1, C)
    dilations = [c.dilation[0] for c in convs]
    per_frame = []
    for xi in x:
        xi = xi[None].permute(0, 2, 3, 1).contiguous()  # a view for channels-last x
        if len(convs) == 1:
            per_frame.append([depthwise3x3_dilated(xi, kernels[0], dilations[0])])
        else:
            per_frame.append(aspp_depthwise3x3_multi(xi, kernels, dilations))
    outs = []
    for b, conv in enumerate(convs):
        ys = [frame[b] for frame in per_frame]
        y = (ys[0] if len(ys) == 1 else torch.cat(ys)).permute(0, 3, 1, 2)
        outs.append(y if conv.bias is None else y + conv.bias.view(1, -1, 1, 1))
    return outs


class ConvBNReLU(nn.Module):
    """Conv2d with optional BN and ReLU (ref conv.py:48-100).

    ``padding`` is an int (pair) or "same" (the TF formula above; an
    asymmetric split pads explicitly before the conv).
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair = 1,
        stride: IntPair = 1,
        padding: Union[str, IntPair] = 0,
        dilation: IntPair = 1,
        groups: int = 1,
        bn: bool = False,
        relu: bool = False,
    ):
        super().__init__()
        if padding == "same":
            (t, b), (l, r) = same_padding(kernel_size, stride, dilation)
        else:
            (t, l) = _pair(padding)
            b, r = t, l
        symmetric = t == b and l == r
        self.pre_pad = None if symmetric else (l, r, t, b)
        conv_cls = (
            DepthwiseConv2d if groups == in_channels and features == in_channels else nn.Conv2d
        )
        self.conv = conv_cls(
            in_channels, features, _pair(kernel_size), stride=_pair(stride),
            padding=(t, l) if symmetric else 0, dilation=_pair(dilation),
            groups=groups, bias=not bn,
        )
        self.bn = nn.BatchNorm2d(features, eps=1e-5) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_pad is not None:
            x = F.pad(x, self.pre_pad)
        return self.post_conv(self.conv(x))

    def post_conv(self, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm and ReLU, for a caller that ran ``self.conv`` itself."""
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.relu(x)
        return x


class DepthwiseSeparableConv(nn.Module):
    """Depthwise conv followed by a pointwise 1x1 conv (ref conv.py:103-145)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: IntPair = 3,
        stride: IntPair = 1,
        padding: Union[str, IntPair] = 0,
        dilation: IntPair = 1,
        depthwise_bn: bool = False,
        pointwise_bn: bool = False,
        depthwise_relu: bool = False,
        pointwise_relu: bool = False,
    ):
        super().__init__()
        self.depthwise_cnn = ConvBNReLU(
            in_channels, in_channels, kernel_size, stride=stride, padding=padding,
            dilation=dilation, groups=in_channels, bn=depthwise_bn, relu=depthwise_relu,
        )
        self.pointwise_cnn = ConvBNReLU(
            in_channels, features, 1, bn=pointwise_bn, relu=pointwise_relu,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_cnn(self.depthwise_cnn(x))

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The rest of the branch after its depthwise conv's output ``y``."""
        return self.pointwise_cnn(self.depthwise_cnn.post_conv(y))
