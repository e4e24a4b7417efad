"""FLOP and byte counts against hand counts and against the convolutions
a forward pass of the reference network actually runs."""
from __future__ import annotations

import json

import pytest
import torch
import torch.nn as nn

from benchmark.counts.flops import conv_flops, deeplab_forward_flops
from benchmark.counts.kernels import H100_BYTES_PER_S, k2_bytes, k3_bytes, k4_bytes
from benchmark.reference.deeplab import DeepLabV3Plus
from benchmark.tests.conftest import REPO


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


@pytest.mark.parametrize("name,hw", [("deeplabv3p-rx50-os8-serve", (65, 97)),
                                     ("deeplabv3p-rx50-os16-train", (129, 96))])
def test_forward_flops_match_the_network(name, hw):
    net = json.loads((REPO / f"benchmark/configs/{name}.json").read_text())["network"]
    with torch.device("meta"):
        model = DeepLabV3Plus(net).eval()
    counted = []

    def hook(m, inputs, out):
        counted.append(2 * out.numel() * m.in_channels // m.groups * m.kernel_size[0]
                       * m.kernel_size[1])

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty((1, 3) + hw, device="meta"))
    assert sum(counted) == deeplab_forward_flops(net, *hw)
