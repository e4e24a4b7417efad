"""FLOP and byte counts against hand counts: the FLOP count, which walks
the convolutions a forward pass of the reference network runs, against a
walk of DeepLabV3+ ResNet(-Xt)'s stages written out by hand."""
from __future__ import annotations

import json
from typing import List, Tuple

import pytest

from benchmark.counts.flops import conv_flops, forward_flops, train_step_flops
from benchmark.counts.kernels import H100_BYTES_PER_S, k2_bytes, k3_bytes, k4_bytes
from benchmark.reference import deeplab
from benchmark.tests.conftest import REPO

# (name, out_h, out_w, cin, cout, k, groups)
Conv = Tuple[str, int, int, int, int, int, int]


def _out(n: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def deeplab_convs(net: dict, h: int, w: int) -> List[Conv]:
    """Every convolution of one (h, w) image's forward pass, by hand."""
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
    """Convolution FLOPs of one (h, w) image's forward pass, by hand."""
    return sum(conv_flops(oh, ow, ci, co, k, g) for _, oh, ow, ci, co, k, g in
               deeplab_convs(net, h, w))


def _net(name: str) -> dict:
    return json.loads((REPO / f"benchmark/configs/{name}.json").read_text())["network"]


def test_hand_counts():
    # 2 ops x 3 x 5 outputs x (4 / 2) input channels x 6 outputs x 9 taps
    assert conv_flops(3, 5, 4, 6, k=3, groups=2) == 2 * 3 * 5 * 2 * 6 * 9
    # (1, 2, 3, 4) bf16: 24 elements x 2 bytes x (1 in + 3 out) + 3 x 9 x 4 f32 taps
    assert k4_bytes(1, 2, 3, 4, 3, 2) == 24 * 2 * 4 + 3 * 9 * 4 * 4
    assert k3_bytes(1, 2, 3, 4, 2) == 24 * 2 * 2 + 9 * 4 * 4
    assert k2_bytes(5, 2, 2) == 3 * 5 * 4 * 4


def test_kernel_table_bounds():
    """The byte bounds of the port's kernel table at its shapes."""
    us = lambda b: b / H100_BYTES_PER_S * 1e6  # noqa: E731
    assert round(us(k4_bytes(1, 180, 240, 2048, 3, 2)), 1) == 211.3
    assert round(us(k3_bytes(1, 180, 240, 2048, 2)), 1) == 105.7
    assert round(us(k2_bytes(5, 2000, 2000)), 1) == 71.6


# the count before the FLOP count walked the reference network: one frame at
# the serving configuration's 1440 x 1920, a crop at the training
# configuration's 513 x 513, and the sizes of the CPU tests (72 x 96 is a
# frame shrunk by ``tiny_root``'s image scale, 65 x 65 its crop)
PINNED = {
    ("deeplabv3p-rx50-os8-serve", (1440, 1920)): 2369179275264,
    ("deeplabv3p-rx50-os8-serve", (72, 96)): 5882535936,
    ("deeplabv3p-rx50-os8-serve", (65, 97)): 6324926848,
    ("deeplabv3p-rx50-os16-train", (513, 513)): 78818530016,
    ("deeplabv3p-rx50-os16-train", (65, 65)): 1655031520,
    ("deeplabv3p-rx50-os16-train", (129, 96)): 3825310144,
}


@pytest.mark.parametrize("name,hw", sorted(PINNED))
def test_forward_flops_match_the_network(name, hw):
    net = _net(name)
    assert forward_flops(deeplab, net, *hw) == PINNED[name, hw] == deeplab_forward_flops(net, *hw)


def test_train_step_flops_pinned():
    """16 crops of 513 x 513: three times the forward's count."""
    net = _net("deeplabv3p-rx50-os16-train")
    assert train_step_flops(deeplab, net, 16, 513, 513) == 3783289440768 == 48 * 78818530016
