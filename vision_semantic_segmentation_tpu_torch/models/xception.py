"""Modified Aligned Xception-65, NCHW ``nn.Module``s.

Port of ``vision_semantic_segmentation_tpu/models/xception.py`` (the
reference's written-but-unwired backbone, ref backbone/xception.py:9-326):
entry flow (2 convs + 3 conv-skip blocks), middle flow (16 sum-skip
blocks), exit flow (1 conv-skip block + 3 separable convs).  Residual
separable convs use TF "same" padding (a stride-2 3x3 pads (0, 1), see
``ConvBNReLU.pre_pad``); blocks optionally expose the pre-ReLU low-level
feature.

Parameter names are the reference torch module's, the names that
``tests/test_xception_parity.py::_remap_keys`` maps from, so a reference
state dict loads with ``load_state_dict(strict=True)``:

  * ``entry_flow_modules.{0,1}`` the stem convs, ``.{2,3,4}`` the entry
    blocks; ``middle_flow_modules.{0..15}``; ``exit_flow_modules.0`` the
    exit block, ``.{1,2,3}`` the exit separable convs;
  * in a block, ``residual_group1.{0,2}`` the first two separable convs
    (ReLUs at 1 and 3), ``residual_group2`` the last one after the zero
    pad where the block has it (``.1``; ``.0`` without the pad), and
    ``skip_connection`` the 1x1 conv shortcut.

Every separable conv with stride 1 (60 a frame: 2 in each entry block, 48
in the middle flow, 3 in the exit block, the 3 exit convs) has a 3x3
depthwise conv whose padding equals its dilation, which runs K3 on the card
(``layers.DepthwiseConv2d``); the stride-2 depthwise convs and every dense
conv run on cuDNN, as the JAX package leaves them to XLA.

The three exit convs run at the atrous rate ``exit_rate``: 1 in the
reference's unwired backbone (and ``XceptionSeg``), 2 under DeepLabV3+ as
TF DeepLab's ``xception_65`` runs them at output stride 16 (the entry flow
reaches the stride, so the exit block's stride 2 becomes 1 and the rate of
the block after it doubles).  The forward marks the three flows as the
spans ``xception.entry``, ``xception.middle`` and ``xception.exit``
(``utils/benchmark.py::span``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.benchmark import span
from .layers import ConvBNReLU, DepthwiseSeparableConv, checkpointed


class XceptionBlock(nn.Module):
    """k separable convs + a conv/sum/none shortcut (ref xception.py:9-152).

    The residual path applies an entry ReLU, then k-1 separable convs each
    followed by ReLU, then a final separable conv without a trailing ReLU.
    ``return_residual_features`` also returns the feature right before the
    last ReLU (the DeepLab low-level tap, taken pre-ReLU).
    """

    def __init__(
        self,
        in_channels: int,
        residual_channels: Sequence[int],
        residual_kernel_size: Sequence[int],
        residual_stride: Sequence[int],
        residual_dilation: Sequence[int],
        skip_type: Optional[str] = None,  # 'conv' | 'sum' | None
        skip_channels: int = 0,
        skip_kernel: int = 1,
        skip_stride: int = 1,
        entry_relu: bool = True,
        return_residual_features: bool = False,
        add_residual_padding: bool = False,
    ):
        super().__init__()
        if skip_type not in ("conv", "sum", None):
            raise ValueError(f"unknown skip_type {skip_type!r}")
        self.entry_relu = entry_relu
        self.return_residual_features = return_residual_features
        self.skip_type = skip_type
        ins = [in_channels, *residual_channels[:-1]]

        def sepconv(i: int) -> DepthwiseSeparableConv:
            return DepthwiseSeparableConv(
                ins[i], residual_channels[i], residual_kernel_size[i],
                stride=residual_stride[i], padding="same", dilation=residual_dilation[i],
                depthwise_bn=True, pointwise_bn=True,
            )

        group1 = []
        for i in range(len(residual_channels) - 1):
            group1 += [sepconv(i), nn.ReLU()]
        self.residual_group1 = nn.ModuleList(group1)
        # the extra (0, 1, 0, 1) zero pad before the strided conv makes the
        # residual and the 1x1/2 shortcut sizes agree (ref :101-102)
        pad = [nn.ZeroPad2d((0, 1, 0, 1))] if add_residual_padding else []
        self.residual_group2 = nn.ModuleList(pad + [sepconv(len(residual_channels) - 1)])
        if skip_type == "conv":
            self.skip_connection = ConvBNReLU(
                in_channels, skip_channels, skip_kernel, stride=skip_stride, padding="same",
                bn=True,
            )

    def forward(self, x: torch.Tensor):
        residual = F.relu(x) if self.entry_relu else x
        low_level = None
        for sep in self.residual_group1[::2]:
            low_level = sep(residual)  # pre-ReLU tap (ref xception.py:133-136)
            residual = F.relu(low_level)
        for m in self.residual_group2:
            residual = m(residual)
        if self.skip_type == "conv":
            out = residual + self.skip_connection(x)
        elif self.skip_type == "sum":
            out = residual + x
        else:
            out = residual
        if self.return_residual_features:
            return out, low_level
        return out


class Xception65(nn.Module):
    """Xception-65 feature extractor (ref xception.py:167-310).

    Returns ``{"feature" (2048 channels, OS16), "low_feature" (256
    channels, OS4, entry block 2's pre-ReLU tap)}``, the backbone contract
    of the DeepLab head.  ``remat`` recomputes each block in the backward
    pass (the JAX package's ``nn.remat`` per block); ``exit_rate`` is the
    dilation of the three exit convs.
    """

    out_channels = 2048
    low_level_channels = 256

    def __init__(self, output_stride: int = 16, remat: bool = False, exit_rate: int = 1):
        super().__init__()
        if output_stride != 16:
            raise NotImplementedError(
                f"backbone xception65 is built at output stride 16, not {output_stride}")
        self.remat = remat

        def entry_block(cin: int, ch: int, tap: bool = False) -> XceptionBlock:
            return XceptionBlock(
                cin, (ch, ch, ch), (3, 3, 3), (1, 1, 2), (1, 1, 1), skip_type="conv",
                skip_channels=ch, skip_kernel=1, skip_stride=2,
                return_residual_features=tap, add_residual_padding=True,
            )

        self.entry_flow_modules = nn.ModuleList([
            ConvBNReLU(3, 32, 3, stride=2, bn=True, relu=True),
            ConvBNReLU(32, 64, 3, stride=1, padding="same", bn=True, relu=True),
            entry_block(64, 128),
            entry_block(128, 256, tap=True),
            entry_block(256, 728),
        ])
        self.middle_flow_modules = nn.ModuleList([
            XceptionBlock(728, (728, 728, 728), (3, 3, 3), (1, 1, 1), (1, 1, 1), skip_type="sum")
            for _ in range(16)
        ])
        exit_convs = [
            DepthwiseSeparableConv(cin, ch, 3, padding="same", dilation=exit_rate,
                                   depthwise_bn=True, depthwise_relu=True, pointwise_bn=True,
                                   pointwise_relu=True)
            for cin, ch in ((1024, 1536), (1536, 1536), (1536, 2048))
        ]
        self.exit_flow_modules = nn.ModuleList([
            XceptionBlock(728, (728, 1024, 1024), (3, 3, 3), (1, 1, 1), (1, 1, 1),
                          skip_type="conv", skip_channels=1024, skip_kernel=1, skip_stride=1),
            *exit_convs,
        ])

    def _block(self, block: XceptionBlock, x: torch.Tensor):
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpointed(block, block, x)
        return block(x)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        stem1, stem2, block1, block2, block3 = self.entry_flow_modules
        with span("xception.entry"):
            x = stem2(stem1(x))
            x = self._block(block1, x)
            x, low_feature = self._block(block2, x)
            x = self._block(block3, x)
        with span("xception.middle"):
            for block in self.middle_flow_modules:
                x = self._block(block, x)
        with span("xception.exit"):
            x = self._block(self.exit_flow_modules[0], x)
            for conv in self.exit_flow_modules[1:]:
                x = conv(x)
        return {"feature": x, "low_feature": low_feature}

