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

import contextlib
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.depthwise import DepthwiseBranches, depthwise_branches

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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training step updates the running variance
    with the biased batch variance, as flax's ``nn.BatchNorm`` does (the JAX
    package's BatchNorm: momentum 0.9 in flax's sense, eps 1e-5).

    ``nn.BatchNorm2d`` folds in the unbiased variance, n / (n - 1) larger
    for n values a channel (a factor of 2 at ASPP's pooled 1x1 branch with
    batch 2).  The fused PyTorch call runs on copies of the running
    buffers, and the variance is corrected after it: with f the update
    factor, ``rv = (1 - f) rv_old + f var_unbiased (n - 1) / n``.  Parameter and
    buffer names are ``nn.BatchNorm2d``'s, so state dicts are unchanged.
    ``recomputing`` (set by :func:`checkpointed` while the backward pass
    recomputes a forward) normalises with the batch statistics and leaves
    the running statistics alone, so a rematerialised step updates them
    once.
    """

    recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if x.numel() == x.shape[1]:
            return self._one_value(x)
        # the fused call updates copies: autograd keeps its inputs, and the
        # running buffers must not change under it
        mean, var = self.running_mean.clone(), self.running_var.clone()
        if self.recomputing:  # the same call, its statistics dropped
            return F.batch_norm(x, mean, var, self.weight, self.bias, True, 0.0, self.eps)
        f = self._factor()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, f, self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            self.running_mean.copy_(mean)
            self.running_var.copy_(var - (var - (1.0 - f) * self.running_var) / n)
        return y

    def _factor(self) -> float:
        """Count the batch; the update factor (``momentum``, or the
        cumulative average's 1 / batches when it is None)."""
        self.num_batches_tracked.add_(1)
        if self.momentum is None:
            return 1.0 / float(self.num_batches_tracked)
        return self.momentum

    def _one_value(self, x: torch.Tensor) -> torch.Tensor:
        """One value a channel (ASPP's pooled branch at batch 1), which
        ``F.batch_norm`` refuses in training: flax's batch variance is 0,
        so the output is the bias."""
        shape = (1, -1, 1, 1)
        y = (x - x) * torch.rsqrt(torch.full_like(x, self.eps)) * self.weight.view(shape)
        y = y + self.bias.view(shape)
        if not self.recomputing:
            f = self._factor()
            with torch.no_grad():
                self.running_mean.mul_(1.0 - f).add_(f * x.reshape(-1).to(self.running_mean.dtype))
                self.running_var.mul_(1.0 - f)
        return y


def checkpointed(module: nn.Module, fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward pass instead of kept (the
    JAX package's ``nn.remat`` / ``jax.checkpoint``).  The BatchNorms of
    ``module`` skip their running-statistics update while recomputing."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]

    @contextlib.contextmanager
    def recompute():
        for m in norms:
            m.recomputing = True
        try:
            yield
        finally:
            for m in norms:
                m.recomputing = False

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


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

    One conv runs K3 per frame; two or more run as one K4 call per frame,
    which reads ``x`` once for all of them.  Where a gradient is needed the
    calls go through ``DepthwiseBranches`` (its backward is K3 on the
    flipped taps for dx and an f32 wgrad); otherwise straight to the
    kernels' custom ops, so an exported graph holds the ops and no autograd
    Function.  On a CPU tensor every step runs the kernels' plain versions.
    Returns one NCHW output per conv.
    """
    # (C, 1, 3, 3) -> (3, 3, 1, C) -> (9, C), tap-major
    w9s = torch.stack([c.weight.permute(2, 3, 1, 0).reshape(9, -1) for c in convs])
    w9s = w9s.to(torch.promote_types(w9s.dtype, torch.float32))
    dilations = tuple(c.dilation[0] for c in convs)
    x = x.permute(0, 2, 3, 1).contiguous()  # no copy for a channels-last x
    if torch.is_grad_enabled() and (x.requires_grad or w9s.requires_grad):
        ys = DepthwiseBranches.apply(x, w9s, dilations)
    else:
        ys = depthwise_branches(x, w9s, dilations)
    outs = []
    for y, conv in zip(ys, convs):
        y = y.permute(0, 3, 1, 2)
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
        self.bn = BatchNorm2d(features, eps=1e-5) if bn else None
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
