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

Every conv that a BatchNorm follows runs through :func:`conv_bn`, which
takes the conv's folded form where a folded eval forward is under way
(``models/fold.py``: the BatchNorm in the conv's weights, the bias, a
residual add and the ReLU in one call) and the modules one by one
otherwise.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
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

    ``group`` (set by :func:`global_batch_statistics` for a data-parallel
    step) takes the statistics over the global batch of every rank of that
    ``torch.distributed`` group: the JAX package's BatchNorm under a
    data-parallel ``jit``, with flax's fast variance ``E[x^2] - E[x]^2``
    clipped at 0 (:class:`_GlobalBatchNorm`).
    """

    recomputing = False
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        ranks = 1 if self.group is None else dist.get_world_size(self.group)
        if x.numel() * ranks == x.shape[1]:
            return self._one_value(x)
        if self.group is not None:
            return self._global_batch(x)
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

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Normalise with the global batch's statistics; the running
        statistics take the global mean and biased variance (not while
        recomputing)."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        if not self.recomputing:
            f = self._factor()
            with torch.no_grad():
                self.running_mean.mul_(1.0 - f).add_(f * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1.0 - f).add_(f * var.to(self.running_var.dtype))
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


class _GlobalBatchNorm(torch.autograd.Function):
    """BatchNorm over the global batch of a ``torch.distributed`` group.

    Forward: one all-reduce of ``[sum x, sum x^2, count]`` a channel (in at
    least f32), mean ``E[x]``, variance ``max(E[x^2] - E[x]^2, 0)``.
    Backward: one all-reduce of ``[sum dy, sum dy * xhat]``; the weight and
    bias gradients stay local (the step's gradient all-reduce sums them).
    Returns the output and the (non-differentiable) global mean and
    variance.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        count = torch.full((1,), x.numel() // c, dtype=xs.dtype, device=x.device)
        stats = torch.cat([xs.sum(dims), (xs * xs).sum(dims), count])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        raw = stats[c:2 * c] / n - mean * mean
        var = raw.clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xs - mean.view(shape)) * invstd.view(shape)
        y = xhat * weight.view(shape).to(xs.dtype) + bias.view(shape).to(xs.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, (raw > 0).to(xs.dtype), n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, moving, n = ctx.saved_tensors
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        dy = dy.to(mean.dtype)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy = sums[:c] / n
        # a variance clipped at 0 passes no gradient (flax's jnp.maximum)
        mean_dy_xhat = sums[c:] / n * moving
        dx = (dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) * (
            invstd * weight.to(mean.dtype)).view(shape)
        return (dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None, None)


@contextlib.contextmanager
def global_batch_statistics(module: nn.Module, group):
    """Within the block, the BatchNorms of ``module`` take their training
    statistics over the global batch of ``group`` (see
    :class:`BatchNorm2d`); the backward pass, and a rematerialised forward
    in it, must run inside the block too."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


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


# the folded forms of the forward under way on this thread, by conv (``models/fold.py``)
_FOLDED: contextvars.ContextVar[Optional[Mapping[nn.Module, Callable]]] = contextvars.ContextVar(
    "folded_forms", default=None)


@contextlib.contextmanager
def folded_forms(forms: Mapping[nn.Module, Callable]):
    """Within the block, :func:`conv_bn` runs each conv in ``forms`` as
    ``forms[conv](x, z, relu)`` (``models/fold.py``)."""
    token = _FOLDED.set(forms)
    try:
        yield
    finally:
        _FOLDED.reset(token)


def conv_bn(conv: nn.Module, bn: Optional[nn.Module], x: torch.Tensor,
            z: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """``relu(bn(conv(x)) + z)``, without the parts not given: the conv's
    folded form inside :func:`folded_forms`, else the modules one by one."""
    forms = _FOLDED.get()
    form = None if forms is None else forms.get(conv)
    if form is not None:
        return form(x, z, relu)
    y = conv(x)
    if bn is not None:
        y = bn(y)
    if z is not None:
        y = y + z
    return F.relu(y) if relu else y


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

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``relu(bn(conv(x)) + z)``: ``z`` a residual added before the ReLU."""
        if self.pre_pad is not None:
            x = F.pad(x, self.pre_pad)
        return conv_bn(self.conv, self.bn, x, z, self.relu)

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

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``z``: a residual the pointwise conv adds (see :class:`ConvBNReLU`)."""
        return self.pointwise_cnn(self.depthwise_cnn(x), z)

    def finish(self, y: torch.Tensor) -> torch.Tensor:
        """The rest of the branch after its depthwise conv's output ``y``."""
        return self.pointwise_cnn(self.depthwise_cnn.post_conv(y))
