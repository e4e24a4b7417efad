"""Plain PyTorch DeepLabV3+ with a ResNet / ResNeXt backbone.

The benchmark's reference network (Chen et al., arXiv:1802.02611; the
ResNeXt bottleneck of Xie et al., arXiv:1611.05431, torchvision's
parameterisation).  It imports nothing of the measured program and uses no
hand-written kernel: convolutions are ``F.conv2d`` (grouped and depthwise
convs too), resizes ``F.interpolate``.  Module and parameter names follow the
published reference code (``backbone.layer1.0.conv2.weight``,
``aspp.module_pyramid.1.depthwise_cnn.conv.weight``, ...), so one state dict
serves the program and this network.

Departures from a textbook DeepLabV3+, each as the published code has it:
the decoder's refine convs are unpadded (each 3x3 trims 2 pixels), the
ASPP branches after the first are depthwise-separable, and the logits stay
at the decoder's resolution unless ``upsample`` is asked for.

``quant`` is the control's hook: a function applied to every convolution's
input and weight before it runs (identity for the reference itself).

A reference module of the benchmark (the contract is in
``benchmark/reference/__init__.py``): ``network``, ``classifier_bias`` and
``residual_bn_weights`` below.  A reference of another backbone hands
``DeepLabV3Plus`` its own backbone and imports the rest from here.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Set

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded by ``fn`` on its way back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight pass through the network's
    ``quant``, and whose output's gradient through ``grad_quant``."""

    quant: Quant = None
    grad_quant: Quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)
        if self.grad_quant is not None and y.requires_grad:
            y = _RoundGrad.apply(y, self.grad_quant)
        return y


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bn: bool = True, relu: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, k, padding=padding, dilation=dilation, groups=groups,
                         bias=not bn)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5) if bn else None
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class SeparableConv(nn.Module):
    """Depthwise k x k (BN, ReLU), then pointwise 1x1 (BN, ReLU)."""

    def __init__(self, cin: int, cout: int, k: int = 3, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.depthwise_cnn = ConvBNReLU(cin, cin, k, padding=padding, dilation=dilation,
                                        groups=cin)
        self.pointwise_cnn = ConvBNReLU(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_cnn(self.depthwise_cnn(x))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, dilation: int, downsample: bool,
                 groups: int, width_per_group: int):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        self.conv1 = Conv(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = Conv(width, width, 3, stride=stride, padding=dilation, dilation=dilation,
                          groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = Conv(width, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(Conv(cin, planes * 4, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Backbone(nn.Module):
    """ResNet(-Xt) with bottleneck blocks; output stride by dilation
    (torchvision's ``replace_stride_with_dilation``)."""

    def __init__(self, layers: Sequence[int], groups: int, width_per_group: int,
                 output_stride: int):
        super().__init__()
        dilate = {8: (False, True, True), 16: (False, False, True),
                  32: (False, False, False)}[output_stride]
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, dilation = 64, 1
        for i, (planes, stride, n) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2), layers)):
            previous = dilation
            if i and dilate[i - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes, stride if b == 0 else 1,
                                         previous if b == 0 else dilation,
                                         b == 0 and (stride != 1 or cin != planes * 4),
                                         groups, width_per_group))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        low = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(low)))
        return {"feature": x, "low_feature": low}


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class ASPP(nn.Module):
    def __init__(self, cin: int, cout: int, channels: Sequence[int], dilations: Sequence[int],
                 dropout: float):
        super().__init__()
        branches = []
        for i, (ch, d) in enumerate(zip(channels, dilations)):
            branches.append(ConvBNReLU(cin, ch, 1) if i == 0
                            else SeparableConv(cin, ch, 3, padding=d, dilation=d))
        self.module_pyramid = nn.ModuleList(branches)
        self.global_avg_pool = nn.Sequential(nn.AdaptiveAvgPool2d(1), ConvBNReLU(cin, 256, 1))
        self.conv = ConvBNReLU(sum(channels) + 256, cout, 1)
        self.dropout = dropout
        # the dropout mask of a training forward, a function of its shape
        # that the caller sets
        self.mask: Optional[Callable[[torch.Size], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [b(x) for b in self.module_pyramid]
        outs.append(_resize(self.global_avg_pool(x), outs[0].shape[-2:]))
        y = self.conv(torch.cat(outs, dim=1))
        if self.training and self.dropout > 0:
            if self.mask is None:
                raise ValueError("a training forward needs the dropout mask")
            y = y * self.mask(y.shape).to(y.dtype) / (1.0 - self.dropout)
        return y


class Decoder(nn.Module):
    def __init__(self, cin: int, low_cin: int, num_classes: int, low_cout: int,
                 refine: Sequence[int]):
        super().__init__()
        self.low_level_conv = ConvBNReLU(low_cin, low_cout, 1)
        layers, ch = [], cin + low_cout
        for c in refine:
            layers.append(SeparableConv(ch, c, 3))
            ch = c
        layers.append(ConvBNReLU(ch, num_classes, 1, bn=False, relu=False))
        self.refine_layers = nn.ModuleList(layers)

    def forward(self, feature: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        low = self.low_level_conv(low)
        x = torch.cat([_resize(feature, low.shape[-2:]), low], dim=1)
        for layer in self.refine_layers:
            x = layer(x)
        return x


class DeepLabV3Plus(nn.Module):
    def __init__(self, net: dict, backbone: Optional[nn.Module] = None):
        """``net``: the ``network`` object of a configuration file.
        ``backbone``: a module whose forward gives ``feature`` (2048
        channels) and ``low_feature`` (256 channels); by default the ResNet
        ``Backbone`` that ``net`` describes."""
        super().__init__()
        self.backbone = backbone if backbone is not None else Backbone(
            net["layers"], net["groups"], net["width_per_group"], net["output_stride"])
        self.aspp = ASPP(2048, net["aspp_out_channels"], net["aspp_atrous_channels"],
                         net["aspp_dilations"], net["aspp_dropout"])
        self.decoder = Decoder(net["aspp_out_channels"], 256, net["num_classes"],
                               net["decoder_low_level_out_channels"],
                               net["decoder_refine_channels"])

    def set_quant(self, quant: Quant, grad_quant: Quant = None) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant, m.grad_quant = quant, grad_quant

    def forward(self, x: torch.Tensor, upsample: bool = False) -> torch.Tensor:
        f = self.backbone(x)
        logits = self.decoder(self.aspp(f["feature"]), f["low_feature"])
        return _resize(logits, x.shape[-2:]) if upsample else logits


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (its largest magnitude
    at e4m3's largest finite value, 448), back in the input's type.  The
    gradient passes straight through (only the forward is rounded)."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


def fp8_grad_quant(g: torch.Tensor) -> torch.Tensor:
    """Round a gradient to float8 e5m2 (the gradients' format of fp8
    training) with one scale a tensor (its largest magnitude at 57344)."""
    scale = g.abs().amax().clamp_min(1e-30) / 57344.0
    return (g / scale).to(torch.float8_e5m2).to(g.dtype) * scale


def network(net: dict) -> DeepLabV3Plus:
    """The configuration's network, built on the current device."""
    return DeepLabV3Plus(net)


def classifier_bias(net: dict) -> str:
    """The state-dict key of the classifier's bias."""
    return f"decoder.refine_layers.{len(net['decoder_refine_channels'])}.conv.bias"


def residual_bn_weights(net: dict, keys: Iterable[str]) -> Set[str]:
    """Of the state-dict ``keys``, the weights of each residual branch's
    last BatchNorm (a bottleneck's ``bn3``)."""
    return {k for k in keys if k.endswith("bn3.weight")}


def normalize(frames_u8: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> (N, 3, H', W') f32, ImageNet statistics.
    ``scale`` < 1 first shrinks each frame by an area average over blocks of
    1 / scale pixels (an integer), rounded back to uint8, as a camera node
    downscales its frames."""
    if scale < 1.0:
        f = round(1.0 / scale)
        if abs(f * scale - 1.0) > 1e-9:
            raise ValueError(f"image scale {scale} is not 1 / an integer")
        x = F.avg_pool2d(frames_u8.permute(0, 3, 1, 2).double(), f).round()
        frames_u8 = x.permute(0, 2, 3, 1).to(torch.uint8)
    mean = torch.tensor([0.485, 0.456, 0.406], device=frames_u8.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=frames_u8.device)
    return ((frames_u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
