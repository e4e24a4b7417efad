"""Eval BatchNorm folded into the serving convs, with the conv's epilogue
doing the bias, the residual add and the ReLU.

An eval BatchNorm is a per-channel affine with fixed statistics: with
``s = gamma / sqrt(running_var + eps)`` and ``t = beta - running_mean * s``
it folds into the conv before it as ``W' = W * s[out]``, ``b' = t``.
:class:`FoldedNetwork` runs a model's own forward with each conv that
:func:`layers.conv_bn` runs replaced by its folded form, one library call
for the conv, its bias, residual add and ReLU where one exists:

* conv -> BN (-> ReLU): the conv with ``W'``, ``b'`` (and the ReLU) fused;
* a ResNet block's tail ``relu(bn3(conv3(h)) + identity)``: the downsample
  conv's BN folds too and its shift joins conv3's bias, so the tail is one
  call, ``relu(conv(h, W3') + identity + b')`` with a bias-free identity conv;
* a separable conv whose depthwise BN has no ReLU (Xception's residual
  convs): that BN folds exactly into the 1x1 that follows, ``W'[o, i] =
  W[o, i] s_pw[o] s_dw[i]``, ``b'[o] = s_pw[o] sum_i W[o, i] t_dw[i] +
  t_pw[o]``; the depthwise conv itself (K3, or a stride-2 cuDNN conv) runs
  unchanged.  An Xception block's shortcut conv gives its shift to the last
  separable conv's bias, as the downsample conv does.

The call a site runs, its form, follows from what the code sees of the
conv (kernel, groups, stride) and of its epilogue (:func:`site_form`); the
table was measured on an H100 (``PERF.md``; ``scripts/probe_fold_forms.py``
measures it again).  A BatchNorm with no measured fused form stays a pass
of its own: each depthwise BN a ReLU follows (ASPP's K4 branches,
Xception's K3 exit convs, the decoder's refine convs).  On the CPU every
form runs its plain PyTorch version.

The folded weights live in tensors of fixed address, which a CUDA graph
reads: :meth:`FoldedNetwork.refresh` compares the source tensors and their
versions with those of the last fold, and refolds in place when any
changed (``load_state_dict``, an in-place edit, a parameter replaced),
outside any capture.  Each fold runs under the span ``model.fold``.
"""
from __future__ import annotations

import operator
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.benchmark import span
from .layers import ConvBNReLU, DepthwiseSeparableConv, folded_forms
from .resnet import BasicBlock, Bottleneck, ResNetBackbone
from .xception import XceptionBlock


class FoldInfo(NamedTuple):
    """What :class:`FoldedNetwork` runs: BatchNorm sites folded into a conv,
    BatchNorm sites left as passes of their own, refolds after the first
    fold, and the forward's conv calls by form (:func:`site_form`)."""
    folded: int
    unfolded: int
    refolds: int
    calls: Dict[str, int]


# -- the fused calls ---------------------------------------------------------------------
def _rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels-last -> its (N*H*W, C) view."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _image(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N*H*W, C') rows -> the channels-last (N, C', H, W) view, H and W of ``like``."""
    n, _, h, w = like.shape
    return rows.view(n, h, w, -1).permute(0, 3, 1, 2)


def _conv_relu(x, w, b, conv: nn.Conv2d) -> torch.Tensor:
    """``relu(conv(x, w) + b)``: cuDNN's conv + bias + ReLU fusion on the card."""
    if x.is_cuda:
        return torch.cudnn_convolution_relu(x, w, b, conv.stride, conv.padding, conv.dilation,
                                            conv.groups)
    return F.relu(F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups))


def _conv_add_relu(x, w, b, z, conv: nn.Conv2d) -> torch.Tensor:
    """``relu(conv(x, w) + z + b)``: cuDNN's conv + bias + add + ReLU fusion on the card."""
    if x.is_cuda:
        return torch.cudnn_convolution_add_relu(x, w, z, 1.0, b, conv.stride, conv.padding,
                                                conv.dilation, conv.groups)
    return F.relu(F.conv2d(x, w, b, conv.stride, conv.padding, conv.dilation, conv.groups) + z)


# the epilogue a site ends with -> (adds a residual, ends with a ReLU):
# "relu" (BN -> ReLU), "add_relu" (BN -> + z -> ReLU), "bias" (BN alone),
# "add" (BN -> + z), "none" (BN whose shift another site adds)
EPILOGUES = {"relu": (False, True), "add_relu": (True, True), "bias": (False, False),
             "add": (True, False), "none": (False, False)}


def site_form(conv: nn.Conv2d, epilogue: str) -> Optional[str]:
    """The call that runs ``conv`` with its folded BatchNorm and
    ``epilogue``, or None where the BatchNorm stays a pass of its own.

    Measured on an H100 in bf16 at the serving networks' sites
    (``PERF.md`` section 6): cuDNN's conv + bias (+ add) + ReLU runs in the
    time of the plain conv for dense, 1x1 and 32-group convs
    (``conv_relu``, ``conv_add_relu``), but 12-28 times slower than conv,
    BatchNorm and ReLU for a depthwise conv, whose BatchNorm therefore
    stays.  A 1x1 stride-1 conv without ReLU is a matrix product of its
    channels-last (N*H*W, C) rows with the bias in cuBLASLt's epilogue
    (``gemm_bias``), the residual one pass more (``gemm_bias_add``: an
    ``addmm`` from the residual copies it first and took twice as long);
    no other conv without ReLU was measured, and its BatchNorm stays.  A
    bias-free conv whose shift another site adds is the plain conv
    (``conv``).
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if conv.groups > 1 and conv.groups == conv.in_channels == conv.out_channels:
        return None  # depthwise
    if epilogue in ("relu", "add_relu", "none"):
        return {"relu": "conv_relu", "add_relu": "conv_add_relu", "none": "conv"}[epilogue]
    pointwise = (conv.kernel_size == (1, 1) and conv.stride == (1, 1)
                 and conv.padding == (0, 0) and conv.groups == 1)
    return None if not pointwise else {"bias": "gemm_bias", "add": "gemm_bias_add"}[epilogue]


def _affine(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval BatchNorm as ``x * s + t``, in f32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


class _Site:
    """One conv with the BatchNorms folded into it, called as
    :func:`layers.conv_bn` calls it.

    ``bn`` follows the conv; ``in_bn`` (a depthwise conv's BN) comes before
    a 1x1 conv and folds into its input channels; each of ``shift_bns``
    (a bias-free shortcut conv's BN) adds its shift to the bias; with
    ``shift`` False this site's own shift is left out (another site adds
    it)."""

    def __init__(self, conv: nn.Conv2d, bn: nn.BatchNorm2d, epilogue: str, form: str,
                 in_bn: Optional[nn.BatchNorm2d] = None, shift_bns: Sequence[nn.BatchNorm2d] = (),
                 shift: bool = True):
        self.conv, self.bn, self.epilogue, self.form = conv, bn, epilogue, form
        self.in_bn, self.shift_bns, self.shift = in_bn, tuple(shift_bns), shift
        self.weight: Optional[torch.Tensor] = None
        self.bias: Optional[torch.Tensor] = None

    def norms(self) -> List[nn.BatchNorm2d]:
        return [m for m in (self.bn, self.in_bn) if m is not None] + list(self.shift_bns)

    def sources(self) -> List[Tuple[Dict[str, torch.Tensor], str]]:
        """Where each tensor the fold reads lives: (a module's dict, name)."""
        out = [(self.conv._parameters, n) for n in ("weight", "bias")
               if self.conv._parameters.get(n) is not None]
        for bn in self.norms():
            out += [(bn._parameters, "weight"), (bn._parameters, "bias"),
                    (bn._buffers, "running_mean"), (bn._buffers, "running_var")]
        return out

    def fold(self) -> None:
        """Compute the folded weight and bias in f32 and store them, in the
        conv's dtype, into this site's tensors (made at the first fold)."""
        conv = self.conv
        w = conv.weight.float()
        b = conv.bias.float() if conv.bias is not None else w.new_zeros(w.shape[0])
        if self.in_bn is not None:  # a 1x1 conv after the depthwise BN
            s_in, t_in = _affine(self.in_bn)
            b = b + w.flatten(1) @ t_in
            w = w * s_in.view(1, -1, 1, 1)
        s, t = _affine(self.bn)
        w = w * s.view(-1, 1, 1, 1)
        b = b * s + (t if self.shift else 0.0)
        for bn in self.shift_bns:
            b = b + _affine(bn)[1]
        if self.weight is None:
            self.weight = torch.empty_like(conv.weight)
            self.bias = torch.empty(w.shape[0], dtype=conv.weight.dtype,
                                    device=conv.weight.device)
        self.weight.copy_(w)
        self.bias.copy_(b)

    def __call__(self, x: torch.Tensor, z: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
        if (z is not None, relu) != EPILOGUES[self.epilogue]:
            raise RuntimeError(f"a conv folded for the epilogue {self.epilogue!r} was called "
                               f"with residual {z is not None}, ReLU {relu}")
        conv, w, b, form = self.conv, self.weight, self.bias, self.form
        if form == "conv_relu":
            return _conv_relu(x, w, b, conv)
        if form == "conv_add_relu":
            return _conv_add_relu(x, w, b, z, conv)
        if form == "conv":
            return F.conv2d(x, w, None, conv.stride, conv.padding, conv.dilation, conv.groups)
        y = _image(torch.addmm(b, _rows(x), w.view(w.shape[0], -1).t()), x)
        return y if z is None else y.add_(z)


class _Bare:
    """A depthwise conv whose BatchNorm the 1x1 conv after it takes in: the
    conv alone (K3 where it applies)."""

    def __init__(self, conv: nn.Conv2d):
        self.conv = conv

    def __call__(self, x: torch.Tensor, z: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
        if z is not None or relu:
            raise RuntimeError("a depthwise conv whose BatchNorm folds downstream was called "
                               "with a residual or a ReLU")
        return self.conv(x)


_VERSION = operator.attrgetter("_version")


class FoldedNetwork:
    """``model``'s eval forward with its BatchNorms folded (see the
    module's docstring), called as the model is.  The model's modules are
    read, never changed: a caller that runs the model itself runs it
    unfolded.  A BatchNorm that no :func:`layers.conv_bn` call of
    :class:`ConvBNReLU`, :class:`DepthwiseSeparableConv`, a ResNet block
    or backbone reaches stays where it is."""

    def __init__(self, model: nn.Module):
        self.model = model
        self._sites: Dict[nn.Module, _Site] = {}
        self._bare: Dict[nn.Module, _Bare] = {}
        self._plan(model)
        self._forms = {**self._sites, **self._bare}
        folded = {bn for site in self._sites.values() for bn in site.norms()}
        self._unfolded = [m for m in model.modules()
                          if isinstance(m, nn.BatchNorm2d) and m not in folded]
        sources = {(id(d), k): (d, k) for site in self._sites.values() for d, k in site.sources()}
        self._dicts = [d for d, _ in sources.values()]
        self._keys = [k for _, k in sources.values()]
        self._seen: List[torch.Tensor] = []
        self._versions: List[int] = []
        self.refolds = 0
        self._fold()

    # -- the plan: which BatchNorm folds where -------------------------------------------
    def _plan(self, model: nn.Module) -> None:
        """Each BatchNorm a site, in ``model.modules()``' order (a parent
        before its children, so that a block names its shortcut's and its
        last conv's epilogues first); a BatchNorm is planned once."""
        self._planned = set()
        for m in model.modules():
            if isinstance(m, ResNetBackbone):
                self._site(m.conv1, m.bn1, "relu")
            elif isinstance(m, (Bottleneck, BasicBlock)):
                self._residual(m)
            elif isinstance(m, XceptionBlock):
                self._xception_block(m)
            elif isinstance(m, DepthwiseSeparableConv):
                self._separable(m)
            elif isinstance(m, ConvBNReLU) and m.bn is not None:
                self._site(m.conv, m.bn, "relu" if m.relu else "bias")
        del self._planned

    def _site(self, conv: nn.Conv2d, bn: nn.BatchNorm2d, epilogue: str,
              **kwargs) -> Optional[_Site]:
        """Fold ``bn`` into ``conv``, unless it is planned already or has no
        fused form (:func:`site_form`)."""
        if bn in self._planned:
            return None
        self._planned.add(bn)
        form = site_form(conv, epilogue)
        if form is not None:
            self._sites[conv] = _Site(conv, bn, epilogue, form, **kwargs)
            self._planned.update(self._sites[conv].norms())
        return self._sites.get(conv)

    def _separable(self, m: DepthwiseSeparableConv, epilogue: Optional[str] = None,
                   shift_bns: Sequence[nn.BatchNorm2d] = ()) -> None:
        """A depthwise BN with no ReLU folds into the 1x1 after it."""
        dw, pw = m.depthwise_cnn, m.pointwise_cnn
        epilogue = epilogue or ("relu" if pw.relu else "bias")
        if pw.bn is None or pw.bn in self._planned:
            return
        in_bn = dw.bn if (dw.bn is not None and not dw.relu and dw.bn not in self._planned
                          and site_form(pw.conv, epilogue) is not None) else None
        self._site(pw.conv, pw.bn, epilogue, in_bn=in_bn, shift_bns=shift_bns)
        if in_bn is not None:
            self._bare[dw.conv] = _Bare(dw.conv)

    def _shortcut(self, conv: nn.Conv2d, bn: nn.BatchNorm2d, into: nn.Conv2d,
                  epilogue: str) -> Sequence[nn.BatchNorm2d]:
        """Fold a shortcut conv's BN, its shift left to the conv ``into``
        that adds the shortcut, where both fold; the BNs whose shift
        ``into`` adds."""
        if site_form(into, epilogue) is None or self._site(conv, bn, "none", shift=False) is None:
            return ()
        return (bn,)

    def _residual(self, block) -> None:
        """A ResNet block: ReLU after each conv but the last, which takes
        the residual add, the ReLU and the downsample BN's shift."""
        convs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
        if isinstance(block, Bottleneck):
            convs.append((block.conv3, block.bn3))
        (*inner, (last, last_bn)) = convs
        for conv, bn in inner:
            self._site(conv, bn, "relu")
        shift_bns = ()
        if block.downsample is not None:
            shift_bns = self._shortcut(*block.downsample, last, "add_relu")
        self._site(last, last_bn, "add_relu", shift_bns=shift_bns)

    def _xception_block(self, block: XceptionBlock) -> None:
        """The last separable conv takes the shortcut and the shortcut
        conv's BN shift."""
        last, shift_bns = block.residual_group2[-1], ()
        epilogue = "add" if block.skip_type else "bias"
        if block.skip_type == "conv":
            skip = block.skip_connection
            shift_bns = self._shortcut(skip.conv, skip.bn, last.pointwise_cnn.conv, epilogue)
        self._separable(last, epilogue, shift_bns)

    # -- the fold ------------------------------------------------------------------------
    def _current(self) -> List[torch.Tensor]:
        return list(map(dict.__getitem__, self._dicts, self._keys))

    @torch.no_grad()
    def _fold(self) -> None:
        with span("model.fold"):
            for site in self._sites.values():
                site.fold()
            self._seen = self._current()
            self._versions = list(map(_VERSION, self._seen))

    def refresh(self) -> bool:
        """Refold in place if a source tensor changed since the last fold
        (another tensor in its place, or its version: ``load_state_dict``,
        an in-place op, a parameter replaced; an edit through ``.data``
        keeps both and is not seen); True if it refolded.  Not while a CUDA
        graph captures: the refold's kernels would join the graph."""
        current = self._current()
        if (all(map(operator.is_, current, self._seen))
                and list(map(_VERSION, current)) == self._versions):
            return False
        self.refolds += 1
        self._fold()
        return True

    def info(self) -> FoldInfo:
        folded = {bn for site in self._sites.values() for bn in site.norms()}
        calls = Counter(site.form for site in self._sites.values())
        return FoldInfo(len(folded), len(self._unfolded), self.refolds, dict(sorted(calls.items())))

    def __call__(self, *args, **kwargs):
        """The model's eval forward, folded."""
        if self.model.training:
            raise RuntimeError("a folded forward is an eval forward: the model is training")
        with folded_forms(self._forms):
            return self.model(*args, **kwargs)
