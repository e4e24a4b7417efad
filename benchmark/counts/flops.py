"""Convolution FLOPs of DeepLabV3+ as a plain function of shape.

Two operations (a multiply and an add) per multiply-add; a grouped
convolution contracts ``cin / groups`` input channels, the same whatever
implements it (``scripts/roofline_backbone.py``'s ``conv_cost``, without its
TPU tile expansion).  Only convolutions count: BatchNorm, ReLU, pooling,
resizes and the loss are left out, as a model-FLOP utilisation counts them.
"""
from __future__ import annotations

from typing import List, Tuple

# (name, out_h, out_w, cin, cout, k, groups)
Conv = Tuple[str, int, int, int, int, int, int]


def conv_flops(out_h: int, out_w: int, cin: int, cout: int, k: int = 1, groups: int = 1) -> int:
    return 2 * out_h * out_w * (cin // groups) * cout * k * k


def _out(n: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def deeplab_convs(net: dict, h: int, w: int) -> List[Conv]:
    """Every convolution of one (h, w) image's forward pass."""
    convs: List[Conv] = []
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    convs.append(("stem", h, w, 3, 64, 7, 1))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    dilate = {8: (False, True, True), 16: (False, False, True),
              32: (False, False, False)}[net["output_stride"]]
    groups, wpg = net["groups"], net["width_per_group"]
    cin, dilation = 64, 1
    low_hw = None
    for i, (planes, stride, n) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2),
                                                net["layers"])):
        previous = dilation
        if i and dilate[i - 1]:
            dilation *= stride
            stride = 1
        width = int(planes * (wpg / 64.0)) * groups
        for b in range(n):
            s = stride if b == 0 else 1
            d = previous if b == 0 else dilation
            oh, ow = _out(h, 3, s, d, d), _out(w, 3, s, d, d)
            convs.append((f"layer{i + 1}.{b}.conv1", h, w, cin, width, 1, 1))
            convs.append((f"layer{i + 1}.{b}.conv2", oh, ow, width, width, 3, groups))
            convs.append((f"layer{i + 1}.{b}.conv3", oh, ow, width, planes * 4, 1, 1))
            if b == 0 and (s != 1 or cin != planes * 4):
                convs.append((f"layer{i + 1}.{b}.downsample", oh, ow, cin, planes * 4, 1, 1))
            h, w, cin = oh, ow, planes * 4
        if i == 0:
            low_hw = (h, w)
    ch = net["aspp_atrous_channels"]
    for i, c in enumerate(ch):
        if i == 0:
            convs.append(("aspp.0", h, w, cin, c, 1, 1))
        else:
            convs.append((f"aspp.{i}.depthwise", h, w, cin, cin, 3, cin))
            convs.append((f"aspp.{i}.pointwise", h, w, cin, c, 1, 1))
    convs.append(("aspp.pool", 1, 1, cin, 256, 1, 1))
    convs.append(("aspp.conv", h, w, sum(ch) + 256, net["aspp_out_channels"], 1, 1))
    lh, lw = low_hw
    low = net["decoder_low_level_out_channels"]
    convs.append(("decoder.low", lh, lw, 256, low, 1, 1))
    c = net["aspp_out_channels"] + low
    for j, out in enumerate(net["decoder_refine_channels"]):
        lh, lw = lh - 2, lw - 2
        convs.append((f"decoder.{j}.depthwise", lh, lw, c, c, 3, c))
        convs.append((f"decoder.{j}.pointwise", lh, lw, c, out, 1, 1))
        c = out
    convs.append(("decoder.classifier", lh, lw, c, net["num_classes"], 1, 1))
    return convs


def deeplab_forward_flops(net: dict, h: int, w: int) -> int:
    """Convolution FLOPs of one (h, w) image's forward pass."""
    return sum(conv_flops(oh, ow, ci, co, k, g) for _, oh, ow, ci, co, k, g in
               deeplab_convs(net, h, w))


def train_step_flops(net: dict, batch: int, h: int, w: int) -> int:
    """A training step's convolution FLOPs: the forward, and a backward of
    twice the forward (the input's and the weight's gradient)."""
    return 3 * batch * deeplab_forward_flops(net, h, w)
