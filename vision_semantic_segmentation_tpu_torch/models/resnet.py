"""ResNet / ResNeXt backbone family.

Port of ``vision_semantic_segmentation_tpu/models/resnet.py``: a
torchvision-compatible ResNet without the classifier head that returns
``{"feature" (2048ch), "low_feature" (256ch)}`` and controls the output
stride by replacing strides with dilation (os16 = dilate layer4, os8 =
dilate layers 3+4; ref backbone/resnet.py:8-127, build.py:4-22).
Parameter names are torchvision's (``layer1.0.conv2.weight``, ...).
Grouped 3x3s are plain ``nn.Conv2d(groups=G)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import BatchNorm2d, checkpointed, conv_bn


def _downsample(inplanes: int, outplanes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(inplanes, outplanes, 1, stride=stride, bias=False),
        BatchNorm2d(outplanes),
    )


class BasicBlock(nn.Module):
    """2-conv residual block (resnet18/34). expansion = 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        identity = x if self.downsample is None else conv_bn(*self.downsample, x)
        return conv_bn(self.conv2, self.bn2, out, z=identity, relu=True)


class Bottleneck(nn.Module):
    """3-conv bottleneck block (resnet50+/resnext). expansion = 4.

    width = planes * (base_width / 64) * groups, grouped 3x3 — torchvision's
    parameterization (resnext50_32x4d = groups 32, width_per_group 4).
    """

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * self.expansion, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.downsample = (
            _downsample(inplanes, planes * self.expansion, stride) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        out = conv_bn(self.conv2, self.bn2, out, relu=True)
        identity = x if self.downsample is None else conv_bn(*self.downsample, x)
        return conv_bn(self.conv3, self.bn3, out, z=identity, relu=True)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor returning high + low level features.

    Args mirror torchvision's ``ResNet`` so any family member is a config:
        block: "basic" or "bottleneck"
        layers: blocks per stage, e.g. (3, 4, 6, 3)
        replace_stride_with_dilation: one flag per stage 2/3/4
    """

    def __init__(
        self,
        block: str = "bottleneck",
        layers: Sequence[int] = (3, 4, 6, 3),
        groups: int = 1,
        width_per_group: int = 64,
        replace_stride_with_dilation: Tuple[bool, bool, bool] = (False, False, False),
        remat: bool = False,
    ):
        super().__init__()
        # TRAIN.REMAT_BACKBONE: each residual block's activations are
        # recomputed in the backward pass (the JAX package's nn.remat per
        # block); only block boundaries are kept
        self.remat = remat
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        expansion = block_cls.expansion
        self.out_channels = 512 * expansion
        self.low_level_channels = 64 * expansion

        # stem: 7x7/2 conv + BN + ReLU + 3x3/2 max-pool (-inf padding, as
        # flax's max_pool)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

        # torchvision _make_layer's stride/dilation bookkeeping: when a stage
        # is dilated its stride moves into the dilation of *subsequent*
        # blocks, while its first block keeps the previous dilation
        inplanes = 64
        dilation = 1
        stage_planes = (64, 128, 256, 512)
        stage_strides = (1, 2, 2, 2)
        dilate_flags = (False,) + tuple(replace_stride_with_dilation)
        for stage_idx in range(4):
            planes = stage_planes[stage_idx]
            stride = stage_strides[stage_idx]
            previous_dilation = dilation
            if dilate_flags[stage_idx]:
                dilation *= stride
                stride = 1
            blocks = []
            for block_idx in range(layers[stage_idx]):
                first = block_idx == 0
                blocks.append(block_cls(
                    inplanes, planes,
                    stride=stride if first else 1,
                    dilation=previous_dilation if first else dilation,
                    downsample=first and (stride != 1 or inplanes != planes * expansion),
                    groups=groups, base_width=width_per_group,
                ))
                inplanes = planes * expansion
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.maxpool(conv_bn(self.conv1, self.bn1, x, relu=True))
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                x = checkpointed(block, block, x) if remat else block(x)
            outs.append(x)
        return {"feature": outs[3], "low_feature": outs[0]}


# -- family (ref backbone/resnet.py:56-177) -----------------------------------
_FAMILY = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": dict(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": dict(block="bottleneck", layers=(3, 4, 23, 3)),
    "resnet152": dict(block="bottleneck", layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(block="bottleneck", layers=(3, 4, 6, 3), groups=32, width_per_group=4),
    "resnext101_32x8d": dict(block="bottleneck", layers=(3, 4, 23, 3), groups=32, width_per_group=8),
    "wide_resnet50_2": dict(block="bottleneck", layers=(3, 4, 6, 3), width_per_group=128),
    "wide_resnet101_2": dict(block="bottleneck", layers=(3, 4, 23, 3), width_per_group=128),
}

__all_backbones__ = sorted(_FAMILY)


def build_backbone(name: str, output_stride: int, remat: bool = False) -> ResNetBackbone:
    """Backbone dispatcher (ref backbone/build.py:4-22).

    output_stride 16 dilates stage 4; output_stride 8 dilates stages 3+4.
    """
    if name not in _FAMILY:
        raise NotImplementedError(f"Unknown backbone {name!r}")
    dilate: Optional[Tuple[bool, bool, bool]] = {
        16: (False, False, True),
        8: (False, True, True),
        32: (False, False, False),
    }.get(output_stride)
    if dilate is None:
        raise NotImplementedError(f"Unsupported output stride {output_stride}")
    return ResNetBackbone(replace_stride_with_dilation=dilate, remat=remat, **_FAMILY[name])
