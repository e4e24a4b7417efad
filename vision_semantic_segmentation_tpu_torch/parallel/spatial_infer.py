"""Spatially sharded (row-banded) forward of the segmentation networks.

Port of ``vision_semantic_segmentation_tpu/parallel/spatial_infer.py``.  The
JAX package shards an image's rows over a mesh axis and lets GSPMD insert
the halo exchanges, the partial-sum all-reduces and the backward's
transposed halos.  PyTorch has no such partitioner, so each of those is
written here: every activation is a :class:`Bands`, one tensor a band on
its shard's device, and every module type of the networks has a banded
form (:class:`SpatialModel`) that reuses the module's own parameters.

* **Row split.**  Each intermediate's rows split as evenly as possible
  (:func:`row_bounds`: band sizes differ by at most one, the larger bands
  first), so row counts that do not divide (180 rows at OS8 over 8 shards,
  the decoder's ``H/4 - 4``) need no padding.
* **Halo fetch.**  :meth:`Bands.fetch` gives a band the global rows
  ``[start, stop)`` from whichever bands hold them, so a halo may span
  several bands, with a fill only outside ``[0, H)``.  It is built from
  slices, ``torch.cat`` and ``.to(device)`` alone: autograd carries the
  cotangents' halos back in the backward pass.
* **Windows.**  A module that pads itself symmetrically (``nn.Conv2d``,
  ``nn.MaxPool2d`` with its -inf pad, K3 and K4 through
  ``layers.depthwise_convs``, Q1) runs on its band extended by real rows
  and is cropped back (:func:`_window`): a band not at the top takes
  ``ceil(p / s) * s`` rows above its first input row, so the module's own
  pad falls on output rows that are cropped, and lands on real data only
  at the image's top and bottom edges.  K4 reads ``band + 2 * max(d)``
  rows, clipped at the edges (:func:`k4_rows`).  An asymmetric pad
  (``ConvBNReLU.pre_pad``, Xception's (0, 1, 0, 1) residual pad) fetches
  with zeros outside the image instead (:func:`_padded_window`).
* **Reductions.**  ASPP's image pooling adds the bands' sums in band order
  and divides by H * W; training BatchNorm adds every band's and data
  shard's ``[sum x, sum x^2, count]`` in a fixed order
  (:class:`_BandBatchNorm`, the math of ``layers._GlobalBatchNorm``).  The
  align-corners resizes fetch the source rows their matrix rows touch.
  ASPP's dropout mask is drawn for the whole tensor, as the unsharded
  module draws it, and sliced per band.

A mesh is one process over ``torch.device`` s (``parallel/mesh.py``); a
device may repeat, so 4 logical shards of ``cuda:0`` run on one card, one
band after another.  Parameters stay replicated: the model on its own
device, a copy on every other distinct device of the mesh
(:meth:`SpatialModel.sync` refreshes the copies, :meth:`reduce_grads` adds
their gradients onto the model's in mesh order).  A module type with no
banded form raises; nothing gathers an intermediate onto one device.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.aspp import ASPP
from ..models.build import XceptionSeg
from ..models.decoder import Decoder
from ..models.deeplab import DeepLabV3Plus
from ..models.layers import (
    BatchNorm2d,
    ConvBNReLU,
    DepthwiseSeparableConv,
    checkpointed,
    depthwise_convs,
)
from ..models.quant import QuantBackbone
from ..models.resize import resize_nchw
from ..models.resnet import BasicBlock, Bottleneck, ResNetBackbone
from ..models.xception import Xception65, XceptionBlock
from ..ops.resize import _align_corners_matrix, _separable_resize
from .mesh import Mesh, _device, distinct

Groups = List[List[torch.device]]


def row_bounds(height: int, shards: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` of each band: sizes differ by at most one, the
    larger bands first."""
    base, extra = divmod(height, shards)
    bounds, start = [], 0
    for b in range(shards):
        stop = start + base + (b < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def split_even(x: torch.Tensor, dim: int, parts: int) -> List[torch.Tensor]:
    """``x`` in ``parts`` slices along ``dim`` by :func:`row_bounds`."""
    return [x.narrow(dim, a, b - a) for a, b in row_bounds(x.shape[dim], parts)]


class Bands:
    """A tensor whose rows lie in bands: ``parts[g][b]`` is data shard g's
    band b on ``devices[g][b]``, holding global rows ``bounds[b]`` of
    ``height`` along dimension ``dim`` (2 for NCHW, 1 for NHWC or labels).
    Every data shard splits its rows the same way."""

    def __init__(self, parts: List[List[torch.Tensor]], devices: Groups, height: int, dim: int):
        self.parts, self.devices, self.height, self.dim = parts, devices, height, dim
        shards = len(devices[0])
        if height < shards:
            raise ValueError(f"{height} rows over {shards} bands leaves a band empty")
        self.bounds = row_bounds(height, shards)

    @classmethod
    def split(cls, x: torch.Tensor, devices: Groups, dim: int) -> "Bands":
        """Split ``x``'s batch (dim 0) over the data shards and its rows over
        the bands; each piece goes to its device."""
        groups = split_even(x, 0, len(devices)) if len(devices) > 1 else [x]
        parts = [[p.to(dev) for p, dev in zip(split_even(g, dim, len(devs)), devs)]
                 for g, devs in zip(groups, devices)]
        return cls(parts, devices, x.shape[dim], dim)

    def like(self, parts: List[List[torch.Tensor]], height: Optional[int] = None,
             dim: Optional[int] = None) -> "Bands":
        return Bands(parts, self.devices, self.height if height is None else height,
                     self.dim if dim is None else dim)

    def map(self, fn: Callable[[torch.Tensor, torch.device], torch.Tensor]) -> "Bands":
        """An op that keeps the rows: ``fn(piece, device)`` on every piece."""
        return self.like([[fn(t, d) for t, d in zip(ts, ds)]
                          for ts, ds in zip(self.parts, self.devices)])

    def zip(self, other: "Bands", fn) -> "Bands":
        """``fn(a, b)`` on the pieces of two tensors of the same height."""
        if other.height != self.height:
            raise ValueError(f"bands of {self.height} and {other.height} rows")
        return self.like([[fn(a, b) for a, b in zip(ts, us)]
                          for ts, us in zip(self.parts, other.parts)])

    @property
    def shards(self) -> List[torch.Tensor]:
        """The pieces in the mesh's device order (JAX's ``addressable_shards``)."""
        return [t for ts in self.parts for t in ts]

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape."""
        first = self.parts[0][0]
        size = list(first.shape)
        size[0] = sum(ts[0].shape[0] for ts in self.parts)
        size[self.dim] = self.height
        return tuple(size)

    def fetch(self, g: int, device: torch.device, start: int, stop: int,
              fill: float = 0.0) -> torch.Tensor:
        """Data shard g's global rows ``[start, stop)`` on ``device``: slices
        of whichever bands hold them, ``fill`` outside ``[0, height)``."""
        dim = self.dim
        pieces = []
        for t, (a, b) in zip(self.parts[g], self.bounds):
            lo, hi = max(start, a), min(stop, b)
            if lo < hi:
                piece = t if (lo, hi) == (a, b) else t.narrow(dim, lo - a, hi - lo)
                pieces.append(piece.to(device))
        template = self.parts[g][0]

        def filler(rows: int) -> torch.Tensor:
            size = list(template.shape)
            size[dim] = rows
            out = torch.full(size, fill, dtype=template.dtype, device=device)
            if template.dim() == 4 and dim == 2:
                out = out.contiguous(memory_format=torch.channels_last)
            return out

        if start < 0:
            pieces.insert(0, filler(-start))
        if stop > self.height:
            pieces.append(filler(stop - self.height))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first band's), for
        a result leaving the forward."""
        device = self.parts[0][0].device if device is None else device
        rows = [torch.cat([t.to(device) for t in ts], self.dim) for ts in self.parts]
        return rows[0] if len(rows) == 1 else torch.cat(rows, 0)


def _window(x: Bands, fn, k: int, s: int, p: int, d: int) -> Bands:
    """A row window that pads itself: ``fn(extended band, device)`` is the
    module's own call (kernel ``k``, stride ``s``, symmetric pad ``p``,
    dilation ``d`` along the rows), run on the band extended by real rows
    and cropped back.  ``fn`` may return a list (K4's branches)."""
    h_out = (x.height + 2 * p - d * (k - 1) - 1) // s + 1
    bounds = row_bounds(h_out, len(x.devices[0]))
    lead = -(-p // s)  # output rows that may read the module's own top pad
    outs = []
    for g, devs in enumerate(x.devices):
        per_band = []
        for (o0, o1), dev in zip(bounds, devs):
            j0 = min(o0, lead)
            start = (o0 - j0) * s
            stop = min(x.height, (o1 - 1) * s - p + (k - 1) * d + 1)
            y = fn(x.fetch(g, dev, start, stop), dev)
            crop = (lambda t: t.narrow(x.dim, j0, o1 - o0))
            per_band.append([crop(t) for t in y] if isinstance(y, (list, tuple)) else crop(y))
        outs.append(per_band)
    if isinstance(outs[0][0], list):
        return [Bands([[band[i] for band in per_band] for per_band in outs], x.devices, h_out,
                      x.dim) for i in range(len(outs[0][0]))]
    return Bands(outs, x.devices, h_out, x.dim)


def _padded_window(x: Bands, fn, k: int, s: int, d: int, top: int, bottom: int) -> Bands:
    """A row window after an explicit, possibly asymmetric zero pad of
    ``top`` and ``bottom`` rows: each band fetches its rows with zeros
    outside the image, and ``fn`` (which pads no rows) computes exactly the
    band's output rows."""
    h_out = (x.height + top + bottom - d * (k - 1) - 1) // s + 1
    bounds = row_bounds(h_out, len(x.devices[0]))
    parts = [[fn(x.fetch(g, dev, o0 * s - top, (o1 - 1) * s + (k - 1) * d + 1 - top), dev)
              for (o0, o1), dev in zip(bounds, devs)] for g, devs in enumerate(x.devices)]
    return Bands(parts, x.devices, h_out, x.dim)


def k4_rows(height: int, shards: int, dilations: Sequence[int]) -> List[int]:
    """The rows K4 (or K3) reads for each band of a ``height``-row map: the
    band and ``max(dilations)`` rows each side, clipped at the edges."""
    dmax = max(dilations)
    return [min(height, o1 + dmax) - max(0, o0 - dmax) for o0, o1 in row_bounds(height, shards)]


def _resize_rows(x: Bands, out_hw: Tuple[int, int]) -> Bands:
    """``resize_nchw`` (align corners) of NCHW bands: each output band
    fetches the source rows its rows of the H matrix touch and applies
    those rows of the matrix; W stays local."""
    out_h, out_w = out_hw
    in_w = x.parts[0][0].shape[-1]
    if (x.height, in_w) == (out_h, out_w):
        return x
    mh = _align_corners_matrix(x.height, out_h)
    mw = _align_corners_matrix(in_w, out_w)
    bounds = row_bounds(out_h, len(x.devices[0]))
    parts = []
    for g, devs in enumerate(x.devices):
        band_parts = []
        for (o0, o1), dev in zip(bounds, devs):
            cols = np.nonzero(mh[o0:o1].any(axis=0))[0]
            lo, hi = int(cols.min()), int(cols.max()) + 1
            src = x.fetch(g, dev, lo, hi)
            y = _separable_resize(src.permute(0, 2, 3, 1).float(),
                                  np.ascontiguousarray(mh[o0:o1, lo:hi]), mw)
            band_parts.append(y.to(src.dtype).permute(0, 3, 1, 2))
        parts.append(band_parts)
    return Bands(parts, x.devices, out_h, x.dim)


class _BandBatchNorm(torch.autograd.Function):
    """Training BatchNorm over pieces on their own devices (the bands and
    data shards of one tensor, or ASPP's pooled vectors).

    ``apply(eps, n, *xs, *weights, *biases)``: n pieces, each with the
    weight and bias of its device's copy.  Forward: ``[sum x, sum x^2,
    count]`` a channel (in at least f32) added in piece order on the first
    piece's device, mean ``E[x]``, variance ``max(E[x^2] - E[x]^2, 0)``
    (``layers._GlobalBatchNorm``'s math, flax's fast variance).  Backward:
    ``[sum dy, sum dy * xhat]`` added likewise.  Returns the n outputs, the
    mean and the biased variance (not differentiable).
    """

    @staticmethod
    def forward(ctx, eps, n, *args):
        xs, ws, bs = args[:n], args[n:2 * n], args[2 * n:]
        c = xs[0].shape[1]
        dims = [0, *range(2, xs[0].dim())]
        shape = (1, c) + (1,) * (xs[0].dim() - 2)
        acc = torch.promote_types(xs[0].dtype, torch.float32)
        home = xs[0].device
        total = None
        for x in xs:
            xf = x.to(acc)
            count = torch.full((1,), x.numel() // c, dtype=acc, device=x.device)
            local = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count]).to(home)
            total = local if total is None else total + local
        count = total[2 * c]
        mean = total[:c] / count
        raw = total[c:2 * c] / count - mean * mean
        var = raw.clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        ys = []
        for x, w, b in zip(xs, ws, bs):
            m, s = mean.to(x.device).view(shape), invstd.to(x.device).view(shape)
            xhat = (x.to(acc) - m) * s
            ys.append((xhat * w.view(shape).to(acc) + b.view(shape).to(acc)).to(x.dtype))
        ctx.save_for_backward(*xs, *ws, mean, invstd, (raw > 0).to(acc), count)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        saved = ctx.saved_tensors
        xs, ws = saved[:n], saved[n:2 * n]
        mean, invstd, moving, count = saved[2 * n:]
        c = xs[0].shape[1]
        dims = [0, *range(2, xs[0].dim())]
        shape = (1, c) + (1,) * (xs[0].dim() - 2)
        home = xs[0].device
        xhats, dys, locals_, total = [], [], [], None
        for x, dy in zip(xs, grads[:n]):
            m, s = mean.to(x.device).view(shape), invstd.to(x.device).view(shape)
            xhat = (x.to(mean.dtype) - m) * s
            dy = torch.zeros_like(xhat) if dy is None else dy.to(mean.dtype)
            local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
            xhats.append(xhat)
            dys.append(dy)
            locals_.append(local)
            total = local.to(home) if total is None else total + local.to(home)
        mean_dy = total[:c] / count
        # a variance clipped at 0 passes no gradient (flax's jnp.maximum)
        mean_dy_xhat = total[c:] / count * moving
        dxs, dws, dbs = [], [], []
        for x, w, xhat, dy, local in zip(xs, ws, xhats, dys, locals_):
            dev = x.device
            scale = (invstd.to(dev) * w.to(mean.dtype)).view(shape)
            dx = (dy - mean_dy.to(dev).view(shape)
                  - xhat * mean_dy_xhat.to(dev).view(shape)) * scale
            dxs.append(dx.to(x.dtype))
            dws.append(local[c:].to(w.dtype))
            dbs.append(local[:c].to(w.dtype))
        return (None, None, *dxs, *dws, *dbs)


class SpatialModel:
    """The banded forward of one network over the ``spatial_axis`` of a
    mesh (rows) and, optionally, its ``data_axis`` (the batch).

    ``model`` stays the one the optimizer steps; every other distinct
    device of the mesh gets a copy (:meth:`sync` refreshes them from the
    model, :meth:`reduce_grads` adds their gradients onto the model's).
    ``__call__`` takes NCHW bands (or an NCHW tensor, split here) and
    returns the logits as bands.  The model's ``training`` flag and
    ``TRAIN.REMAT_BACKBONE`` apply as in its own forward.
    """

    def __init__(self, model: nn.Module, mesh: Mesh, spatial_axis: str = "grid",
                 data_axis: Optional[str] = None):
        self.model = model
        self.mesh = mesh
        if data_axis is None:
            self.groups: Groups = [mesh.along(spatial_axis)]
        else:
            self.groups = [list(row) for row in mesh.submesh(data_axis, spatial_axis).devices]
        devices = distinct(d for ds in self.groups for d in ds)
        param = next(model.parameters(), None)
        self.home = devices[0] if param is None else param.device
        self.devices = devices
        self._copies = {dev: model if dev == self.home else copy.deepcopy(model).to(dev)
                        for dev in devices}
        self._subs = {dev: {id(m): r for m, r in zip(model.modules(), rep.modules())}
                      for dev, rep in self._copies.items()}
        self.qbackbones: Dict[torch.device, QuantBackbone] = {}

    # -- replicas ----------------------------------------------------------------
    def rep(self, module: nn.Module, device: torch.device) -> nn.Module:
        """``module``'s copy on ``device``."""
        return self._subs[device][id(module)]

    def sync(self) -> None:
        """Copy the model's parameters and buffers into the other devices'
        copies, and their training flags."""
        with torch.no_grad():
            for dev, rep in self._copies.items():
                if rep is self.model:
                    continue
                rep.train(self.model.training)
                for a, b in zip(self.model.parameters(), rep.parameters()):
                    b.copy_(a)
                for a, b in zip(self.model.buffers(), rep.buffers()):
                    b.copy_(a)

    def zero_grad(self) -> None:
        for rep in self._copies.values():
            rep.zero_grad(set_to_none=True)

    def reduce_grads(self) -> None:
        """Each parameter's gradient: the sum of its copies' gradients, in
        the mesh's device order, on the model's copy."""
        if len(self._copies) == 1:
            return
        copies = [list(self._copies[d].parameters()) for d in self.devices]
        for i, p in enumerate(self.model.parameters()):
            total = None
            for params in copies:
                g = params[i].grad
                if g is not None:
                    g = g.to(p.device)
                    total = g.clone() if total is None else total.add_(g)
            p.grad = total

    def set_qpack(self, qpack, dtype: torch.dtype,
                  home: Optional[QuantBackbone] = None) -> None:
        """Serve the int8 backbone of ``qpack`` (``models/quant.py``'s form):
        a ``QuantBackbone`` with its sites on each device (``home``: the
        model's own, if built).  Calibration scales are static, so the bands
        reduce nothing.  ``None`` serves the float backbone again."""
        self.qbackbones = {} if qpack is None else {
            dev: (home if dev == self.home and home is not None else
                  QuantBackbone(self._copies[dev].backbone, qpack, dtype, dev))
            for dev in self.devices}

    # -- entry -------------------------------------------------------------------
    def split(self, x: torch.Tensor, dim: int = 2) -> Bands:
        return Bands.split(x, self.groups, dim)

    def __call__(self, x, upsample_pred: bool = True) -> Bands:
        bands = x if isinstance(x, Bands) else self.split(x)
        model = self.model
        if isinstance(model, DeepLabV3Plus):
            return self._deeplab(model, bands, upsample_pred)
        if not isinstance(model, XceptionSeg):
            raise NotImplementedError(f"no banded form for {type(model).__name__}")
        feats = self.xception65(model.backbone, bands)
        logits = self.module(model.classifier, feats["feature"])
        if upsample_pred:
            logits = _resize_rows(logits.map(lambda t, _: t.float()), (bands.height, bands.shape[-1]))
        return logits

    def _deeplab(self, model: DeepLabV3Plus, x: Bands, upsample_pred: bool) -> Bands:
        if self.qbackbones:
            feats = self.quant_backbone(x)
        else:
            feats = self.backbone(model.backbone, x)
        feature = self.aspp(model.aspp, feats["feature"])
        logits = self.decoder(model.decoder, feature, feats["low_feature"])
        if upsample_pred:
            logits = _resize_rows(logits.map(lambda t, _: t.float()), (x.height, x.shape[-1]))
        return logits

    # -- generic modules ---------------------------------------------------------
    def module(self, m: nn.Module, x: Bands) -> Bands:
        """``m`` on bands, by its type."""
        if isinstance(m, ConvBNReLU):
            return self.conv_bn_relu(m, x)
        if isinstance(m, DepthwiseSeparableConv):
            return self.conv_bn_relu(m.pointwise_cnn, self.conv_bn_relu(m.depthwise_cnn, x))
        if isinstance(m, BatchNorm2d):
            return self.batch_norm(m, x)
        if isinstance(m, nn.Conv2d):
            k, s, p, d = m.kernel_size[0], m.stride[0], m.padding[0], m.dilation[0]
            if (k, s, p) == (1, 1, 0):
                return x.map(lambda t, dev: self.rep(m, dev)(t))
            return _window(x, lambda t, dev: self.rep(m, dev)(t), k, s, p, d)
        if isinstance(m, nn.MaxPool2d):
            k, s, p, d = (v if isinstance(v, int) else v[0]
                          for v in (m.kernel_size, m.stride, m.padding, m.dilation))
            if m.ceil_mode:
                raise NotImplementedError("no banded form for MaxPool2d with ceil_mode")
            return _window(x, lambda t, dev: m(t), k, s, p, d)
        if isinstance(m, nn.ZeroPad2d):
            left, right, top, bottom = m.padding
            return _padded_window(x, lambda t, dev: F.pad(t, (left, right, 0, 0)), 1, 1, 1,
                                  top, bottom)
        if isinstance(m, nn.ReLU):
            return x.map(lambda t, _: F.relu(t))
        if isinstance(m, nn.Dropout):
            return self.dropout(m, x)
        if isinstance(m, nn.Sequential):
            for sub in m:
                x = self.module(sub, x)
            return x
        raise NotImplementedError(f"no banded form for {type(m).__name__}")

    def conv_bn_relu(self, m: ConvBNReLU, x: Bands) -> Bands:
        if m.pre_pad is not None:
            left, right, top, bottom = m.pre_pad
            conv = m.conv
            y = _padded_window(x, lambda t, dev: self.rep(conv, dev)(F.pad(t, (left, right, 0, 0))),
                               conv.kernel_size[0], conv.stride[0], conv.dilation[0], top, bottom)
        else:
            y = self.module(m.conv, x)
        return self.post_conv(m, y)

    def post_conv(self, m: ConvBNReLU, y: Bands) -> Bands:
        if m.bn is not None:
            y = self.batch_norm(m.bn, y)
        return y.map(lambda t, _: F.relu(t)) if m.relu else y

    def batch_norm(self, m: BatchNorm2d, x: Bands) -> Bands:
        parts = self._batch_norm(m, [t for ts in x.parts for t in ts],
                                 [d for ds in x.devices for d in ds])
        shards = len(x.devices[0])
        return x.like([parts[i:i + shards] for i in range(0, len(parts), shards)])

    def _batch_norm(self, m: BatchNorm2d, pieces: List[torch.Tensor],
                    devices: List[torch.device]) -> List[torch.Tensor]:
        """BatchNorm of a tensor in pieces: per piece with the running
        statistics in eval; over every piece in training, the running
        statistics updated once on the model's copy (not while a
        checkpoint recomputes)."""
        if not (m.training and m.track_running_stats):
            return [self.rep(m, dev)(t) for t, dev in zip(pieces, devices)]
        if m.group is not None:
            raise NotImplementedError("banded BatchNorm over a process group")
        reps = [self.rep(m, dev) for dev in devices]
        n = len(pieces)
        outs = _BandBatchNorm.apply(m.eps, n, *pieces, *[r.weight for r in reps],
                                    *[r.bias for r in reps])
        ys, mean, var = list(outs[:n]), outs[n], outs[n + 1]
        if not m.recomputing:
            f = m._factor()
            with torch.no_grad():
                m.running_mean.mul_(1.0 - f).add_(f * mean.to(m.running_mean))
                m.running_var.mul_(1.0 - f).add_(f * var.to(m.running_var))
        return ys

    def dropout(self, m: nn.Dropout, x: Bands) -> Bands:
        """The unsharded module's draw: a mask for the whole tensor from the
        home device's generator (``F.dropout`` of ones in the activation's
        type and layout), sliced per band."""
        if not m.training or m.p == 0.0:
            return x
        first = x.parts[0][0]
        shape = x.shape
        ones = torch.ones(shape, dtype=first.dtype, device=self.home)
        if first.dim() == 4 and first.stride(1) == 1 and first.shape[1] > 1:  # channels last
            ones = ones.contiguous(memory_format=torch.channels_last)
        mask = F.dropout(ones, m.p, True)
        parts, n0 = [], 0
        for ts, ds in zip(x.parts, x.devices):
            nb = ts[0].shape[0]
            rows = mask.narrow(0, n0, nb)
            parts.append([t * rows.narrow(x.dim, a, b - a).to(dev)
                          for t, dev, (a, b) in zip(ts, ds, x.bounds)])
            n0 += nb
        return x.like(parts)

    def _block(self, owner: nn.Module, block: nn.Module, fn, x: Bands, remat: bool):
        """``fn(x)`` on bands, under ``checkpointed`` (the halo fetches run
        again inside the recompute) when ``remat``."""
        if not (remat and owner.training and torch.is_grad_enabled()):
            return fn(x)
        flat = x.shards
        shards = len(x.devices[0])
        meta = {}

        def run(*pieces):
            y = fn(x.like([list(pieces[i:i + shards]) for i in range(0, len(pieces), shards)]))
            ys = y if isinstance(y, tuple) else (y,)
            meta["out"] = [(b.height, b.dim) for b in ys]
            return tuple(t for b in ys for t in b.shards)

        out = checkpointed(block, run, *flat)
        results, i, count = [], 0, len(flat)
        for height, dim in meta["out"]:
            pieces = list(out[i:i + count])
            results.append(Bands([pieces[j:j + shards] for j in range(0, count, shards)],
                                 x.devices, height, dim))
            i += count
        return tuple(results) if len(results) > 1 else results[0]

    # -- ResNet ------------------------------------------------------------------
    def backbone(self, bb: nn.Module, x: Bands) -> Dict[str, Bands]:
        if isinstance(bb, Xception65):
            return self.xception65(bb, x)
        if not isinstance(bb, ResNetBackbone):
            raise NotImplementedError(f"no banded form for {type(bb).__name__}")
        x = self.module(bb.conv1, x)
        x = self.batch_norm(bb.bn1, x).map(lambda t, _: F.relu(t))
        x = self.module(bb.maxpool, x)
        outs = []
        for layer in (bb.layer1, bb.layer2, bb.layer3, bb.layer4):
            for block in layer:
                x = self._block(bb, block, lambda b, blk=block: self.residual_block(blk, b), x,
                                bb.remat)
            outs.append(x)
        return {"feature": outs[3], "low_feature": outs[0]}

    def residual_block(self, block: nn.Module, x: Bands) -> Bands:
        relu = lambda t, _: F.relu(t)  # noqa: E731
        if isinstance(block, Bottleneck):
            out = self.batch_norm(block.bn1, self.module(block.conv1, x)).map(relu)
            out = self.batch_norm(block.bn2, self.module(block.conv2, out)).map(relu)
            out = self.batch_norm(block.bn3, self.module(block.conv3, out))
        elif isinstance(block, BasicBlock):
            out = self.batch_norm(block.bn1, self.module(block.conv1, x)).map(relu)
            out = self.batch_norm(block.bn2, self.module(block.conv2, out))
        else:
            raise NotImplementedError(f"no banded form for {type(block).__name__}")
        identity = self.module(block.downsample, x) if block.downsample is not None else x
        return out.zip(identity, lambda a, b: F.relu(a + b))

    # -- ASPP and the decoder ----------------------------------------------------
    def aspp(self, aspp: ASPP, x: Bands) -> Bands:
        fused = aspp.fused_branches()
        depthwise = {}
        if fused:
            convs = [aspp.module_pyramid[i].depthwise_cnn.conv for i in fused]
            dmax = max(c.dilation[0] for c in convs)
            ys = _window(x, lambda t, dev: depthwise_convs([self.rep(c, dev) for c in convs], t),
                         3, 1, dmax, dmax)
            depthwise = dict(zip(fused, ys))
        outs = []
        for i, branch in enumerate(aspp.module_pyramid):
            if i in depthwise:
                y = self.post_conv(branch.depthwise_cnn, depthwise[i])
                outs.append(self.conv_bn_relu(branch.pointwise_cnn, y))
            else:
                outs.append(self.module(branch, x))
        outs.append(self.image_pool(aspp, x, outs[0]))
        cat = outs[0].like([[torch.cat(ps, dim=1) for ps in zip(*per_group)]
                            for per_group in zip(*[o.parts for o in outs])])
        return self.dropout(aspp.dropout, self.conv_bn_relu(aspp.conv, cat))

    def image_pool(self, aspp: ASPP, x: Bands, like: Bands) -> Bands:
        """ASPP's image pooling: per data shard, the bands' f32 sums added in
        band order over H * W, the 1x1 ConvBNReLU on the pooled vectors
        (BatchNorm over every data shard's), then each band's rows of the
        align-corners upsample of a 1x1 map (constant)."""
        conv = aspp.global_avg_pool[1]
        width = x.shape[-1]
        pooled, homes = [], []
        for ts, ds in zip(x.parts, x.devices):
            home = ds[0]
            total = None
            for t in ts:
                part = t.float().sum((2, 3), keepdim=True).to(home)
                total = part if total is None else total + part
            pooled.append((total / float(x.height * width)).to(ts[0].dtype))
            homes.append(home)
        pooled = [self.rep(conv.conv, dev)(t) for t, dev in zip(pooled, homes)]
        if conv.bn is not None:
            pooled = self._batch_norm(conv.bn, pooled, homes)
        if conv.relu:
            pooled = [F.relu(t) for t in pooled]
        w_out = like.shape[-1]
        return like.like([[resize_nchw(p.to(dev), (b - a, w_out))
                           for dev, (a, b) in zip(ds, like.bounds)]
                          for p, ds in zip(pooled, like.devices)])

    def decoder(self, dec: Decoder, feature: Bands, low_level: Bands) -> Bands:
        low = self.conv_bn_relu(dec.low_level_conv, low_level)
        feature = _resize_rows(feature, (low.height, low.shape[-1]))
        x = feature.zip(low, lambda a, b: torch.cat([a, b], dim=1))
        for layer in dec.refine_layers:
            x = self.module(layer, x)
        return x

    # -- Xception ----------------------------------------------------------------
    def xception_block(self, block: XceptionBlock, x: Bands):
        relu = lambda t, _: F.relu(t)  # noqa: E731
        residual = x.map(relu) if block.entry_relu else x
        low_level = None
        for sep in block.residual_group1[::2]:
            low_level = self.module(sep, residual)
            residual = low_level.map(relu)
        for m in block.residual_group2:
            residual = self.module(m, residual)
        if block.skip_type == "conv":
            out = residual.zip(self.conv_bn_relu(block.skip_connection, x), torch.add)
        elif block.skip_type == "sum":
            out = residual.zip(x, torch.add)
        else:
            out = residual
        return (out, low_level) if block.return_residual_features else out

    def xception65(self, bb: Xception65, x: Bands) -> Dict[str, Bands]:
        stem1, stem2, block1, block2, block3 = bb.entry_flow_modules

        def run(block, b):
            return self._block(bb, block, lambda y: self.xception_block(block, y), b, bb.remat)

        x = self.module(stem2, self.module(stem1, x))
        x = run(block1, x)
        x, low_feature = run(block2, x)
        x = run(block3, x)
        for block in bb.middle_flow_modules:
            x = run(block, x)
        x = run(bb.exit_flow_modules[0], x)
        for conv in bb.exit_flow_modules[1:]:
            x = self.module(conv, x)
        return {"feature": x, "low_feature": low_feature}

    # -- the int8 backbone -------------------------------------------------------
    def quant_backbone(self, x: Bands) -> Dict[str, Bands]:
        """``QuantBackbone`` on bands: the float stem, then per block the
        quantize pass, the 1x1 sites (``_int_mm``) per band, the 3x3 sites
        (Q1) on halo-extended bands, the strided downsample's rows fetched
        at its stride phase."""
        qb = self.qbackbones[self.home]
        bb = qb.backbone
        h = x.map(lambda t, _: t.to(qb.dtype))
        h = self.module(bb.conv1, h)
        h = self.batch_norm(bb.bn1, h).map(lambda t, _: F.relu(t))
        h = self.module(bb.maxpool, h)
        h = h.like([[t.permute(0, 2, 3, 1).contiguous() for t in ts] for ts in h.parts], dim=1)
        low = None
        for blk in qb.plan:
            h = self._quant_block(blk, h)
            if blk["stage"] == 0:
                low = h
        nchw = lambda b: b.like([[t.permute(0, 3, 1, 2) for t in ts] for ts in b.parts], dim=2)  # noqa: E731
        return {"feature": nchw(h), "low_feature": nchw(low)}

    def _site(self, name: str, x: Bands) -> Bands:
        site = self.qbackbones[self.home].sites[name]

        def call(t, dev):
            if not t.is_contiguous() or t.data_ptr() % 16:  # a cropped band: Q1 reads
                t = t.contiguous() if not t.is_contiguous() else t.clone()  # aligned rows
            return self.qbackbones[dev].sites[name](t)

        if site.pointwise:
            if site.stride == 1:
                return x.map(call)
            return _window(x, call, 1, site.stride, 0, 1)
        return _window(x, call, 3, site.stride, site.padding, site.dilation)

    def _quant_block(self, blk, h: Bands) -> Bands:
        name = blk["name"]
        sites = self.qbackbones[self.home].sites
        conv1 = sites[f"{name}/conv1"]
        xq = h.map(lambda t, dev: self.qbackbones[dev].sites[f"{name}/conv1"].quantize(t))
        out = self._site(f"{name}/conv1", xq)
        out = self._site(f"{name}/conv2", out)
        if blk["bottleneck"]:
            out = self._site(f"{name}/conv3", out)
        identity = h
        if blk["downsample"]:
            down = sites[f"{name}/downsample_0"]
            xd = xq if down.in_scale_value == conv1.in_scale_value else h.map(
                lambda t, dev: self.qbackbones[dev].sites[f"{name}/downsample_0"].quantize(t))
            identity = self._site(f"{name}/downsample_0", xd)
        dtype = self.qbackbones[self.home].dtype
        return out.zip(identity, lambda a, b: torch.relu(a.float() + b.float()).to(dtype))


def make_spatial_forward(model: nn.Module, mesh: Mesh, axis: str = "grid",
                         upsample_pred: bool = False, argmax: bool = True,
                         band_output: Optional[bool] = None):
    """The forward with image rows banded over ``mesh[axis]`` (JAX
    ``make_spatial_forward``).

    Returns ``forward(variables, image)``: ``variables`` from
    :func:`replicate_variables` (one state dict per distinct device of the
    mesh, loaded into the forward's own copies of ``model`` when a new one
    is passed), ``image`` an (N, H, W, C) float tensor or its bands from
    :func:`shard_image`.  The result is (N, H', W') int32 class ids with
    ``argmax``, else NCHW logits (the port's layout).  ``band_output``
    (default: ``upsample_pred``) returns :class:`Bands` (``.shards``: the
    pieces in mesh order, ``.gather()``: the whole), and requires the output
    rows to divide by the shard count; otherwise the whole result on the
    mesh's first device.
    """
    if band_output is None:
        band_output = upsample_pred
    state = {"variables": None, "engine": None}

    def forward(variables, image):
        if state["engine"] is None or variables is not state["variables"]:
            base = copy.deepcopy(model).eval()
            first = _device(mesh.along(axis)[0])
            base.load_state_dict(variables[first], strict=True)
            engine = SpatialModel(base.to(first), mesh, spatial_axis=axis)
            for dev in engine.devices:
                if dev != first:
                    engine._copies[dev].load_state_dict(variables[dev], strict=True)
            state.update(variables=variables, engine=engine)
        engine = state["engine"]
        if isinstance(image, Bands):
            x = image.like([[t.permute(0, 3, 1, 2) for t in ts] for ts in image.parts], dim=2)
        else:
            x = engine.split(torch.as_tensor(image).permute(0, 3, 1, 2))
        with torch.no_grad():
            out = engine(x, upsample_pred=upsample_pred)
            if argmax:
                out = out.like([[torch.argmax(t, dim=1).to(torch.int32) for t in ts]
                                for ts in out.parts], dim=1)
        if band_output:
            if out.height % len(out.devices[0]):
                raise ValueError(f"a banded output of {out.height} rows does not divide over "
                                 f"{len(out.devices[0])} shards")
            return out
        return out.gather()

    return forward


def shard_image(mesh: Mesh, image, axis: str = "grid") -> Bands:
    """An (N, H, W, C) image with its rows banded over ``axis``."""
    x = torch.as_tensor(np.asarray(image) if not isinstance(image, torch.Tensor) else image)
    return Bands.split(x, [[_device(d) for d in mesh.along(axis)]], 1)


def replicate_variables(mesh: Mesh, variables) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """One copy of a state dict (or a module's) on each distinct device of
    the mesh."""
    if isinstance(variables, nn.Module):
        variables = variables.state_dict()
    return {dev: {k: torch.as_tensor(v).to(dev) for k, v in variables.items()}
            for dev in distinct(mesh.devices.flat)}
