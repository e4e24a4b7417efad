"""Where a configuration's network runs K3, as a plain function of shape.

K3 (``depthwise3x3_dilated``) is a depthwise 3x3 with stride 1 whose
padding equals its dilation.  The sites are found on the configuration's
reference network (``benchmark/reference/__init__.py``) run once on the
meta device, each depthwise ``nn.Conv2d`` of its backbone taken by the
output it gives, so the count follows the work the reference defines and
not the launches a program makes.  ASPP's atrous branches pass the same
test but run as one K4 launch, and are left out with the rest of the head.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from .kernels import k3_bytes


def _is_k3(m: nn.Conv2d) -> bool:
    d = m.dilation[0]
    return (m.groups == m.in_channels == m.out_channels and m.kernel_size == (3, 3)
            and m.stride == (1, 1) and m.dilation == (d, d) and m.padding == (d, d))


def k3_sites(reference, net: dict, h: int, w: int) -> List[Tuple[int, int, int]]:
    """(height, width, channels) of each K3 site of one (h, w) image's
    forward pass through the backbone, in the order they run."""
    with torch.device("meta"):
        model = reference.network(net).eval()
    sites: List[Tuple[int, int, int]] = []

    def record(m: nn.Conv2d, inputs, out: torch.Tensor) -> None:
        _, c, oh, ow = out.shape
        sites.append((oh, ow, c))

    for m in model.backbone.modules():
        if isinstance(m, nn.Conv2d) and _is_k3(m):
            m.register_forward_hook(record)
    with torch.no_grad():
        model(torch.empty((1, 3, h, w), device="meta"))
    return sites


def k3_frame_bytes(reference, net: dict, h: int, w: int, itemsize: int) -> int:
    """Bytes K3 needs for one frame: ``k3_bytes`` summed over its sites."""
    return sum(k3_bytes(1, sh, sw, c, itemsize) for sh, sw, c in k3_sites(reference, net, h, w))
