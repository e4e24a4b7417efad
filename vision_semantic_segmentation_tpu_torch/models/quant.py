"""Int8 post-training quantization (PTQ) of the segmentation backbone.

Port of ``vision_semantic_segmentation_tpu/models/quant.py``.  Quantization
is an offline transform of the float weights into a *qpack*: per backbone
conv site, int8 weights with per-output-channel scales, the folded
BatchNorm affine (``_EPS`` 1e-5) and calibrated per-tensor activation
scales (symmetric, absmax).  The int8 backbone then runs with int8 tensors
between the convs of a block, as the JAX package's walker does
(``quant.py:158-217``):

* the stem (7x7 conv, BatchNorm, ReLU, max-pool) stays float, in the
  network's compute dtype;
* one quantize pass per block, at its input;
* conv1 and conv2 emit int8, their ReLU folded into the ``[0, 127]`` clip;
  conv3 and the downsample emit float for the residual add.

The 3x3 sites run Q1 (``ops/kernels/int8_conv.py``, a hand-written CUDA
kernel on the card); the 1x1 sites are ``torch._int_mm`` over the NHWC
activations as (N*H*W, Cin) rows (a strided downsample takes its stride as
a slice), followed by the same epilogue.  Activations stay channels last.

The ``.npz`` file is the JAX package's: keys ``site|field`` with the flax
site names (``layer1_0/conv1``, ``layer2_0/downsample_0``, ...), dense
kernels HWIO, grouped kernels in the tile-diagonal ``(kh, kw, T, cin_t,
cout_t)`` form of ``_expand_tile_diag`` (``quant.py:91-117``), so each
package reads a qpack the other wrote.  In memory the port keeps every
kernel as ``nn.Conv2d``'s ``(cout, cin / groups, kh, kw)`` int8 (the
tile-diagonal zeros are exact, so the two forms hold the same values) with
the site's ``groups``: it executes an int8 grouped conv, not the
tile-diagonal form.

Calibration records each site's input absmax with forward pre-hooks on the
port's own ``ResNetBackbone`` convs, in the network's compute dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.int8_conv import epilogue, int8_conv3x3
from .resize import resize_nchw
from .resnet import Bottleneck, ResNetBackbone

_EPS = 1e-5  # resnet.py BatchNorm epsilon
_TINY = 1e-12
LANE_TILE = 128  # the JAX package's tile-diagonal factorization width

Qpack = Dict[str, Dict[str, Any]]


# -- the walk over blocks ----------------------------------------------------------
def stage_plan(backbone: ResNetBackbone) -> List[Dict[str, Any]]:
    """One entry per residual block, read off the port's module (the JAX
    ``_stage_plan``, ``quant.py:125``): flax block name, stride, dilation,
    downsample, stage, the block's kind and its 3x3 groups."""
    plan = []
    for stage in range(4):
        for i, block in enumerate(getattr(backbone, f"layer{stage + 1}")):
            bottleneck = isinstance(block, Bottleneck)
            strided = block.conv2 if bottleneck else block.conv1
            plan.append(dict(
                name=f"layer{stage + 1}_{i}", block=block, bottleneck=bottleneck,
                stride=strided.stride[0], dilation=strided.dilation[0],
                downsample=block.downsample is not None, stage=stage,
                groups=block.conv2.groups,
            ))
    return plan


def _sites(plan) -> List[Dict[str, Any]]:
    """Every quantized conv site in plan order: its flax name, the port's
    module path, its BatchNorm, what it emits and where it sends int8."""
    sites = []
    for blk in plan:
        name, b = blk["name"], blk["block"]
        path = name.replace("_", ".")
        d, st = blk["dilation"], blk["stride"]

        def site(cname, conv, bn, emit_to, relu, stride=1, dilation=1, groups=1):
            sites.append(dict(
                site=f"{name}/{cname}", block=path, module=f"{path}.{cname.replace('_', '.')}",
                conv=conv, bn=bn, emit_to=emit_to, relu=relu, stride=stride,
                padding=dilation if conv.kernel_size[0] == 3 else 0, dilation=dilation,
                groups=groups))

        if blk["bottleneck"]:
            site("conv1", b.conv1, "bn1", f"{name}/conv2", True)
            site("conv2", b.conv2, "bn2", f"{name}/conv3", True, st, d, blk["groups"])
            site("conv3", b.conv3, "bn3", None, False)
        else:
            site("conv1", b.conv1, "bn1", f"{name}/conv2", True, st, d)
            site("conv2", b.conv2, "bn2", None, False, 1, d)
        if blk["downsample"]:
            site("downsample_0", b.downsample[0], "downsample.1", None, False, st)
    return sites


def backbone_groups(backbone: ResNetBackbone) -> int:
    """The groups of the backbone's grouped 3x3s (ResNeXt's 32; 1 for ResNet)."""
    return backbone.layer1[0].conv2.groups


# -- the tile-diagonal form of the qpack file --------------------------------------
def _tile_count(in_ch: int, groups: int, features: int) -> int:
    """T of ``_expand_tile_diag``: one tile per 128 input lanes, or 1."""
    tiles = in_ch // LANE_TILE if in_ch % LANE_TILE == 0 else 1
    if not (tiles > 1 and groups % tiles == 0 and features % tiles == 0):
        tiles = 1
    return tiles


def pack_tile_diag(w: np.ndarray, groups: int) -> np.ndarray:
    """Grouped ``(cout, cin/groups, kh, kw)`` -> ``(kh, kw, T, cin_t, cout_t)``
    with zeros off the diagonal blocks (JAX ``_expand_tile_diag``)."""
    cout, cg, kh, kw = w.shape
    in_ch = cg * groups
    tiles = _tile_count(in_ch, groups, cout)
    per_tile, cout_g = groups // tiles, cout // groups
    dense = np.zeros((kh, kw, tiles, in_ch // tiles, cout // tiles), w.dtype)
    hwio = w.transpose(2, 3, 1, 0)
    for g in range(groups):
        t, p = divmod(g, per_tile)
        dense[:, :, t, p * cg:(p + 1) * cg, p * cout_g:(p + 1) * cout_g] = \
            hwio[:, :, :, g * cout_g:(g + 1) * cout_g]
    return dense


def unpack_tile_diag(dense: np.ndarray, groups: int) -> np.ndarray:
    """``(kh, kw, T, cin_t, cout_t)`` -> grouped ``(cout, cin/groups, kh, kw)``."""
    kh, kw, tiles, cin_t, cout_t = dense.shape
    in_ch, cout = tiles * cin_t, tiles * cout_t
    if in_ch % groups or cout % groups or groups % tiles \
            or _tile_count(in_ch, groups, cout) != tiles:
        raise ValueError(f"a tile-diagonal kernel {dense.shape} does not hold {groups} groups")
    cg, cout_g, per_tile = in_ch // groups, cout // groups, groups // tiles
    hwio = np.empty((kh, kw, cg, cout), dense.dtype)
    for g in range(groups):
        t, p = divmod(g, per_tile)
        hwio[:, :, :, g * cout_g:(g + 1) * cout_g] = \
            dense[:, :, t, p * cg:(p + 1) * cg, p * cout_g:(p + 1) * cout_g]
    return np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))


# -- calibration and quantization --------------------------------------------------
def calibrate_backbone(backbone: ResNetBackbone, frames: Iterable) -> Dict[str, float]:
    """Per-site input absmax over calibration frames (NHWC f32 batches,
    preprocessed like inference inputs), in the backbone's dtype and on its
    device; max over frames, as Python floats."""
    param = next(backbone.parameters())
    sites = _sites(stage_plan(backbone))
    seen: Dict[str, torch.Tensor] = {}
    hooks = [s["conv"].register_forward_pre_hook(
        lambda m, args, name=s["site"]: seen.__setitem__(name, args[0].abs().amax()))
        for s in sites]
    training = backbone.training
    backbone.eval()
    absmax: Dict[str, float] = {}
    try:
        with torch.no_grad():
            for f in frames:
                x = torch.as_tensor(np.asarray(f, np.float32), device=param.device)
                backbone(x.permute(0, 3, 1, 2).to(dtype=param.dtype,
                                                  memory_format=torch.channels_last))
                values = torch.stack([seen[s["site"]].float() for s in sites]).tolist()
                for s, v in zip(sites, values):
                    absmax[s["site"]] = max(absmax.get(s["site"], 0.0), v)
    finally:
        for h in hooks:
            h.remove()
        backbone.train(training)
    return absmax


def _bn_affine(state, prefix: str):
    """Inference BatchNorm as (scale, bias) per channel, f32."""
    gamma, beta, mean, var = (np.asarray(state[f"{prefix}.{k}"].float().cpu(), np.float32)
                              for k in ("weight", "bias", "running_mean", "running_var"))
    s = gamma / np.sqrt(var + np.float32(_EPS))
    return s, beta - mean * s


def quantize_backbone(backbone: ResNetBackbone, act_absmax: Dict[str, float],
                      state=None) -> Qpack:
    """The qpack from the backbone's float weights (``state``: its state dict,
    by default the module's own) and the calibrated absmax: int8 kernels
    with per-output-channel scales, the BatchNorm affine, ``in_scale`` and,
    for int8-emitting sites, ``out_scale`` (the consumer's ``in_scale``)."""
    state = backbone.state_dict() if state is None else state
    qpack: Qpack = {}
    for s in _sites(stage_plan(backbone)):
        kernel = np.asarray(state[f"{s['module']}.weight"].float().cpu(), np.float32)
        w_scale = np.maximum(np.abs(kernel).max(axis=(1, 2, 3)), _TINY) / 127.0
        w_q = np.clip(np.round(kernel / w_scale[:, None, None, None]), -127, 127)
        bn_s, bn_b = _bn_affine(state, f"{s['block']}.{s['bn']}")
        entry = dict(w_q=w_q.astype(np.int8), w_scale=w_scale.astype(np.float32),
                     bn_scale=bn_s, bn_bias=bn_b,
                     in_scale=np.float32(max(act_absmax[s["site"]], _TINY) / 127.0),
                     groups=s["groups"])
        if s["emit_to"] is not None:
            entry["out_scale"] = np.float32(max(act_absmax[s["emit_to"]], _TINY) / 127.0)
        qpack[s["site"]] = entry
    return qpack


def quantize_deeplab(model: nn.Module, frames, state=None) -> Qpack:
    """Calibrate ``model.backbone`` on ``frames`` (NHWC f32, preprocessed
    like inference inputs) and quantize it from ``state`` (the network's
    state dict, by default the module's own)."""
    if not isinstance(getattr(model, "backbone", None), ResNetBackbone):
        raise ValueError("int8 quantization needs a DeepLabV3+ network with a ResNet backbone")
    bb_state = None
    if state is not None:
        bb_state = {k[len("backbone."):]: v for k, v in state.items()
                    if k.startswith("backbone.")}
    absmax = calibrate_backbone(model.backbone, frames)
    return quantize_backbone(model.backbone, absmax, bb_state)


# -- the qpack file ----------------------------------------------------------------
def save_qpack(qpack: Qpack, path: str) -> None:
    """Write a qpack as the JAX package's ``.npz`` (keys ``site|field``)."""
    flat = {}
    for site, entry in qpack.items():
        for field, v in entry.items():
            if field == "groups":
                continue
            if field == "w_q":
                v = pack_tile_diag(v, entry["groups"]) if entry["groups"] > 1 \
                    else v.transpose(2, 3, 1, 0)
            flat[f"{site}|{field}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_qpack(path: str, groups: int = 1) -> Qpack:
    """Read a qpack written by either package.  ``groups``: the backbone's
    grouped-conv count (:func:`backbone_groups`), by which a tile-diagonal
    kernel unpacks to ``(cout, cin/groups, kh, kw)``."""
    qpack: Qpack = {}
    with np.load(path) as z:
        for key in z.files:
            site, field = key.rsplit("|", 1)
            qpack.setdefault(site, {})[field] = z[key]
    for entry in qpack.values():
        w = entry["w_q"]
        entry["groups"] = groups if w.ndim == 5 else 1
        entry["w_q"] = unpack_tile_diag(w, groups) if w.ndim == 5 else \
            np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    return qpack


# -- the int8 executor -------------------------------------------------------------
def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 rows times (N, K) int8 weights -> (M, N) int32 sums.

    ``torch._int_mm`` takes its second operand column-major (``w.t()`` of a
    contiguous ``w``), and on CUDA more than 16 rows: fewer are padded with
    zero rows.
    """
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    return torch._int_mm(a, w.t())[:m]


class _Site:
    """One conv site on the device: execution weights and epilogue vectors."""

    def __init__(self, spec: Dict[str, Any], entry: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device):
        self.stride, self.padding, self.dilation = spec["stride"], spec["padding"], spec["dilation"]
        self.groups, self.relu = spec["groups"], spec["relu"]
        self.pointwise = spec["conv"].kernel_size[0] == 1
        w = np.asarray(entry["w_q"], np.int8)
        # 1x1: (cout, cin); 3x3: (cout, 3, 3, cin/groups), Q1's layout
        w = w[:, :, 0, 0] if self.pointwise else w.transpose(0, 2, 3, 1)
        self.w = torch.from_numpy(np.ascontiguousarray(w)).to(device)
        self.in_scale_value = float(entry["in_scale"])
        self.in_scale = torch.tensor([self.in_scale_value], dtype=torch.float32, device=device)
        # the JAX package's order, in f32 (quant.py:394-411)
        total = np.float32(entry["in_scale"]) * entry["w_scale"] * entry["bn_scale"]
        bias = np.asarray(entry["bn_bias"], np.float32)
        if spec["emit_to"] is not None:
            out_scale = np.float32(entry["out_scale"])
            scale, shift, self.out_dtype = total / out_scale, bias / out_scale, torch.int8
        else:
            scale, shift, self.out_dtype = total, bias, dtype
        self.scale = torch.from_numpy(np.asarray(scale, np.float32)).to(device)
        self.shift = torch.from_numpy(np.asarray(shift, np.float32)).to(device)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Float NHWC -> int8 at this site's input scale (a true f32 divide)."""
        return torch.round(x.float() / self.in_scale).clamp_(-127.0, 127.0).to(torch.int8)

    def __call__(self, xq: torch.Tensor) -> torch.Tensor:
        if not self.pointwise:
            return int8_conv3x3(xq, self.w, self.scale, self.shift, self.stride, self.padding,
                                self.dilation, self.groups, self.out_dtype, self.relu)
        if self.stride > 1:
            xq = xq[:, ::self.stride, ::self.stride].contiguous()
        n, h, w, c = xq.shape
        acc = int8_matmul(xq.reshape(n * h * w, c), self.w)
        return epilogue(acc, self.scale, self.shift, self.out_dtype, self.relu).view(n, h, w, -1)


class QuantBackbone:
    """The int8 backbone of one network, on its device.

    Built from the float ``backbone`` (whose stem it runs) and a port qpack;
    ``dtype`` is the network's compute dtype.  Calling it maps an (N, 3, H,
    W) input to ``{"feature", "low_feature"}`` as ``ResNetBackbone`` does,
    channels-last NCHW views in ``dtype``.
    """

    def __init__(self, backbone: ResNetBackbone, qpack: Qpack, dtype: torch.dtype,
                 device: Optional[torch.device] = None):
        device = next(backbone.parameters()).device if device is None else device
        self.backbone = backbone
        self.dtype = dtype
        self.plan = stage_plan(backbone)
        specs = _sites(self.plan)
        missing = [s["site"] for s in specs if s["site"] not in qpack]
        if missing:
            raise ValueError(f"the qpack has no site {missing[0]} of this backbone "
                             f"({len(missing)} missing)")
        self.sites = {s["site"]: _Site(s, qpack[s["site"]], dtype, device) for s in specs}

    def _block(self, blk, h: torch.Tensor, record) -> torch.Tensor:
        name = blk["name"]
        conv1 = self.sites[f"{name}/conv1"]
        xq = conv1.quantize(h)  # one quantize pass per block

        def run(cname, x):
            y = self.sites[f"{name}/{cname}"](x)
            if record is not None:
                record[f"{name}/{cname}"] = y
            return y

        out = run("conv1", xq)
        out = run("conv2", out)
        if blk["bottleneck"]:
            out = run("conv3", out)
        identity = h
        if blk["downsample"]:
            down = self.sites[f"{name}/downsample_0"]
            xd = xq if down.in_scale_value == conv1.in_scale_value else down.quantize(h)
            identity = run("downsample_0", xd)
        return torch.relu(out.float() + identity.float()).to(self.dtype)

    def __call__(self, x: torch.Tensor, record: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """``record``: a dict that receives each site's output (NHWC)."""
        bb = self.backbone
        h = bb.maxpool(F.relu(bb.bn1(bb.conv1(x.to(self.dtype)))))
        h = h.permute(0, 2, 3, 1).contiguous()
        low = None
        for blk in self.plan:
            h = self._block(blk, h, record)
            if blk["stage"] == 0:
                low = h  # the last stage-0 block's output
        return {"feature": h.permute(0, 3, 1, 2), "low_feature": low.permute(0, 3, 1, 2)}


def quant_deeplab_forward(model: nn.Module, qbackbone: QuantBackbone, x: torch.Tensor,
                          upsample_pred: bool = False) -> torch.Tensor:
    """DeepLabV3+ with the int8 backbone (JAX ``quant_deeplab_apply``): the
    model's own float ASPP (K4 on the card) and decoder, then the
    align-corners upsample of the logits to the input size when
    ``upsample_pred``."""
    feats = qbackbone(x)
    feature = model.aspp(feats["feature"])
    logits = model.decoder(feature, feats["low_feature"])
    if upsample_pred:
        logits = resize_nchw(logits.float(), x.shape[-2:])
    return logits
