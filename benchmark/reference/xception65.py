"""Plain PyTorch DeepLabV3+ on the modified aligned Xception-65.

The DeepLabV3+ paper's own network (Chen et al., arXiv:1802.02611, section
4.2; TF DeepLab's ``core/xception.py::xception_65``) at output stride 16:
the entry flow (two stem convs and three blocks with a 1x1 stride-2
shortcut), the middle flow (sixteen blocks with an identity shortcut) and
the exit flow (one block with a 1x1 shortcut, then three separable convs at
the atrous rate ``net["exit_rate"]``).  Every separable conv is a depthwise
3x3 with BatchNorm, then a pointwise 1x1 with BatchNorm.  It imports nothing
of the measured program: convolutions are ``F.conv2d``, and ASPP, the
decoder and the head are ``benchmark/reference/deeplab.py``'s.  Parameter
names are the measured program's (``backbone.entry_flow_modules.2.
residual_group1.0.depthwise_cnn.conv.weight``, ...), so one state dict
serves both.

Departures from TF DeepLab's ``xception_65``, each as the reference code
that the measured program follows has it:

- the first stem conv (3x3, stride 2) is unpadded: 719 x 959 at
  1440 x 1920, where TF's ``conv2d_same`` gives 720 x 960;
- each entry block pads its last residual input by (0, 1, 0, 1) before the
  stride-2 separable conv pads it "same" again (two rows and columns in all,
  at the bottom and the right);
- the pre-ReLU output of the second separable conv of entry block 2 is the
  low-level feature (256 channels at output stride 4);
- the separable convs put no ReLU between depthwise and pointwise inside a
  residual block, but ReLU the block's input and the output of each
  separable conv but the last; the exit flow's three convs ReLU both halves;
- the decoder's refine convs (separable) are unpadded, each 3x3 trimming 2
  pixels, where TF pads them "same"; ASPP's atrous branches are separable
  (as TF's ``aspp_with_separable_conv``), and the logits stay at the
  decoder's resolution unless ``upsample`` is asked for.

A reference module of the benchmark (the contract is in
``benchmark/reference/__init__.py``): ``network``, ``classifier_bias`` and
``residual_bn_weights`` below.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Set

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import deeplab
from benchmark.reference.deeplab import ConvBNReLU


class SepConv(nn.Module):
    """Depthwise 3x3 (BN, optional ReLU), then pointwise 1x1 (BN, optional
    ReLU).  A stride-2 depthwise conv pads TF's "same" way, (0, 1, 0, 1);
    a stride-1 one pads its dilation on every side."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1,
                 relu: bool = False):
        super().__init__()
        self.stride = stride
        self.depthwise_cnn = ConvBNReLU(cin, cin, 3, padding=dilation if stride == 1 else 0,
                                        dilation=dilation, groups=cin, relu=relu)
        self.depthwise_cnn.conv.stride = (stride, stride)
        self.pointwise_cnn = ConvBNReLU(cin, cout, 1, relu=relu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = F.pad(x, (0, 1, 0, 1))
        return self.pointwise_cnn(self.depthwise_cnn(x))


class Block(nn.Module):
    """ReLU, three separable convs (ReLU after the first two), and a
    shortcut: a 1x1 conv with BatchNorm (``conv_skip``) or the identity.
    ``strided`` (an entry block): the last separable conv and the 1x1
    shortcut have stride 2, the former after the (0, 1, 0, 1) pad."""

    def __init__(self, cin: int, channels: Sequence[int], conv_skip: bool,
                 strided: bool = False):
        super().__init__()
        ins = [cin, *channels[:-1]]
        self.residual_group1 = nn.ModuleList([SepConv(ins[0], channels[0]), nn.ReLU(),
                                              SepConv(ins[1], channels[1]), nn.ReLU()])
        last = SepConv(ins[2], channels[2], stride=2 if strided else 1)
        self.residual_group2 = nn.ModuleList(
            [nn.ZeroPad2d((0, 1, 0, 1)), last] if strided else [last])
        self.skip_connection = (ConvBNReLU(cin, channels[2], 1, relu=False) if conv_skip
                                else None)
        if conv_skip and strided:
            self.skip_connection.conv.stride = (2, 2)

    def forward(self, x: torch.Tensor):
        """The block's output and the pre-ReLU output of its second
        separable conv."""
        tap = self.residual_group1[2](F.relu(self.residual_group1[0](F.relu(x))))
        r = F.relu(tap)
        for m in self.residual_group2:
            r = m(r)
        return r + (x if self.skip_connection is None else self.skip_connection(x)), tap


class Xception65Ref(nn.Module):
    """The backbone: ``feature`` (2048 channels, output stride 16) and
    ``low_feature`` (256 channels, output stride 4)."""

    def __init__(self, exit_rate: int):
        super().__init__()
        stem1 = ConvBNReLU(3, 32, 3)
        stem1.conv.stride = (2, 2)
        self.entry_flow_modules = nn.ModuleList([
            stem1,
            ConvBNReLU(32, 64, 3, padding=1),
            Block(64, (128, 128, 128), conv_skip=True, strided=True),
            Block(128, (256, 256, 256), conv_skip=True, strided=True),
            Block(256, (728, 728, 728), conv_skip=True, strided=True),
        ])
        self.middle_flow_modules = nn.ModuleList(
            [Block(728, (728, 728, 728), conv_skip=False) for _ in range(16)])
        self.exit_flow_modules = nn.ModuleList([
            Block(728, (728, 1024, 1024), conv_skip=True),
            *[SepConv(cin, cout, dilation=exit_rate, relu=True)
              for cin, cout in ((1024, 1536), (1536, 1536), (1536, 2048))],
        ])

    def forward(self, x: torch.Tensor):
        stem1, stem2, block1, block2, block3 = self.entry_flow_modules
        x, _ = block1(stem2(stem1(x)))
        x, low = block2(x)
        x, _ = block3(x)
        for block in self.middle_flow_modules:
            x, _ = block(x)
        x, _ = self.exit_flow_modules[0](x)
        for conv in self.exit_flow_modules[1:]:
            x = conv(x)
        return {"feature": x, "low_feature": low}


def network(net: dict) -> deeplab.DeepLabV3Plus:
    """The configuration's network, built on the current device."""
    if net["output_stride"] != 16:
        raise NotImplementedError("Xception-65 is built at output stride 16")
    return deeplab.DeepLabV3Plus(net, Xception65Ref(net["exit_rate"]))


classifier_bias = deeplab.classifier_bias


def residual_bn_weights(net: dict, keys: Iterable[str]) -> Set[str]:
    """Of the state-dict ``keys``, the weights of each residual branch's
    last BatchNorm: the pointwise BatchNorm of the last separable conv of
    each of the 20 blocks (3 entry, 16 middle, 1 exit)."""
    return {k for k in keys if k.startswith("backbone.") and
            k.endswith(("residual_group2.0.pointwise_cnn.bn.weight",
                        "residual_group2.1.pointwise_cnn.bn.weight"))}
