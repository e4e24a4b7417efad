"""Convolution FLOPs of a configuration's network as a plain function of shape.

Two operations (a multiply and an add) per multiply-add; a grouped
convolution contracts ``cin / groups`` input channels, the same whatever
implements it (``scripts/roofline_backbone.py``'s ``conv_cost``, without its
TPU tile expansion).  Only convolutions count: BatchNorm, ReLU, pooling,
resizes and the loss are left out, as a model-FLOP utilisation counts them.

The convolutions are those the configuration's reference network
(``benchmark/reference/__init__.py``) runs: one forward pass on the meta
device, each ``nn.Conv2d`` counted by the output it gives, so a network of
any family is counted with no walk of its own.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn


def conv_flops(out_h: int, out_w: int, cin: int, cout: int,
               k: Union[int, Tuple[int, int]] = 1, groups: int = 1) -> int:
    kh, kw = (k, k) if isinstance(k, int) else k
    return 2 * out_h * out_w * (cin // groups) * cout * kh * kw


def forward_flops(reference, net: dict, h: int, w: int) -> int:
    """Convolution FLOPs of one (h, w) image's forward pass (logits at the
    network's own resolution)."""
    with torch.device("meta"):
        model = reference.network(net).eval()
    total = [0]

    def count(m: nn.Conv2d, inputs, out: torch.Tensor) -> None:
        n, cout, oh, ow = out.shape
        total[0] += n * conv_flops(oh, ow, m.in_channels, cout, m.kernel_size, m.groups)

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(count)
    with torch.no_grad():
        model(torch.empty((1, 3, h, w), device="meta"))
    return total[0]


def train_step_flops(reference, net: dict, batch: int, h: int, w: int) -> int:
    """A training step's convolution FLOPs: the forward, and a backward of
    twice the forward (the input's and the weight's gradient)."""
    return 3 * batch * forward_flops(reference, net, h, w)
