"""Time each conv site of the serving networks in every candidate form of
a conv with its BatchNorm folded (``models/fold.py::site_form``'s table).

Needs an NVIDIA card.  Builds the ResNeXt50 OS8 and Xception-65 OS16
DeepLabV3+ of the replay cells in bf16, records the input shape of every
conv in one forward over a 1440x1920 frame and the epilogue the fold gives
it, and for each distinct site (input shape, conv, epilogue) times, in
CUDA graphs of ``--reps`` calls replayed ``--replays`` times (CUDA events):

* the unfolded forms: ``conv``, ``conv_bn``, ``conv_bn_relu``,
  ``conv_bn_add``, ``conv_bn_add_relu`` (the conv, then eval BatchNorm,
  add and ReLU as passes of their own);
* cuDNN's fusions: ``cudnn_relu`` (``torch.cudnn_convolution_relu``),
  ``cudnn_add_relu`` (``torch.cudnn_convolution_add_relu``);
* for a 1x1 stride-1 conv, a matrix product of the channels-last
  (N*H*W, C) rows: ``gemm``, ``gemm_bias`` (``addmm``, the bias in
  cuBLASLt's epilogue), ``gemm_bias_relu`` (``_addmm_activation``),
  ``gemm_bias_add`` (``addmm`` then an add), ``gemm_add_bias``
  (``addmm`` from the residual, then the bias).

Depthwise convs are timed as cuDNN runs them (``F.conv2d``), K3's sites
too.  Each fused form's largest difference from the f32 answer, over its
largest magnitude, is ``rel_err``.  Prints one line a site, then a row a
(site class, epilogue): the sites, us a frame summed over them (time x
count) for the unfolded form, each fused candidate and the form the fold
runs; writes every number to ``--out``::

    python scripts/probe_fold_forms.py --out build/probe_fold_forms.json
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults  # noqa: E402
from vision_semantic_segmentation_tpu_torch.models import build_model, fold  # noqa: E402

NETWORKS = {"rx50": ("resnext50_32x4d", 8, 256), "xc65": ("xception65", 16, 48)}
# an epilogue -> the unfolded form, the fused candidates
CANDIDATES = {
    "relu": ("conv_bn_relu", ("cudnn_relu", "gemm_bias_relu")),
    "add_relu": ("conv_bn_add_relu", ("cudnn_add_relu",)),
    "bias": ("conv_bn", ("gemm_bias",)),
    "add": ("conv_bn_add", ("gemm_bias_add", "gemm_add_bias")),
    "none": ("conv_bn", ("conv",)),
    "bare": ("conv_bn", ("conv",)),  # a depthwise conv whose BN folds into the next conv
    "relu, BN stays": ("conv_bn_relu", ("cudnn_relu",)),
}
# ``site_form``'s names -> the probe's
FORMS = {"conv_relu": "cudnn_relu", "conv_add_relu": "cudnn_add_relu", "gemm_bias": "gemm_bias",
         "gemm_bias_add": "gemm_bias_add", "conv": "conv"}


def sites(backbone: str, output_stride: int, low: int):
    """{(input shape, conv's shape, epilogue): [conv, count, first name, the
    fold's form]} over one forward of the network at 1440x1920 in bf16; a
    conv no BatchNorm follows is left out."""
    cfg = get_cfg_defaults()
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE, net.MODEL.OUTPUT_STRIDE = backbone, output_stride
    net.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = low
    model = build_model(net, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    folded = fold.FoldedNetwork(model)
    with_bn = {m.conv for m in model.modules() if getattr(m, "bn", None) is not None}
    with_bn |= {m.downsample[0] for m in model.modules() if getattr(m, "downsample", None)}
    with_bn |= {getattr(m, n) for m in model.modules() for n in ("conv1", "conv2", "conv3")
                if isinstance(getattr(m, n, None), nn.Conv2d)}
    found, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and m in with_bn:
            site = folded._sites.get(m)
            epilogue, form = ((site.epilogue, FORMS[site.form]) if site is not None
                              else ("bare", "conv") if m in folded._bare
                              else ("relu, BN stays", "conv_bn_relu"))

            def hook(m, args, name=name, epilogue=epilogue, form=form):
                key = (tuple(args[0].shape), m.out_channels, m.kernel_size, m.stride, m.padding,
                       m.dilation, m.groups, epilogue)
                found.setdefault(key, [m, 0, name, form])[1] += 1
            hooks.append(m.register_forward_pre_hook(hook))
    x = torch.randn(1, 3, 1440, 1920, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        model(x.contiguous(memory_format=torch.channels_last), upsample_pred=False)
    for h in hooks:
        h.remove()
    return found


def site_class(conv: nn.Conv2d) -> str:
    if conv.groups > 1:
        return "depthwise" if conv.groups == conv.in_channels == conv.out_channels else "grouped"
    return "1x1" if conv.kernel_size == (1, 1) else "dense"


def timed(fn, reps: int, replays: int) -> float:
    """us a call: ``fn`` ``reps`` times in one CUDA graph, replayed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * replays)


def forms(conv: nn.Conv2d, shape, dtype=torch.bfloat16):
    """{form: (callable, fused?)} at this site, on random inputs."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, device="cuda", dtype=dtype, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = conv.weight.detach().to(dtype)
    c = w.shape[0]
    b = torch.randn(c, device="cuda", dtype=dtype, generator=g) * 0.1
    args = (conv.stride, conv.padding, conv.dilation, conv.groups)
    y = F.conv2d(x, w, None, *args)
    z = torch.randn(y.shape, device="cuda", dtype=dtype, generator=g).contiguous(
        memory_format=torch.channels_last)
    mean, var = torch.zeros(c, device="cuda", dtype=dtype), torch.ones(c, device="cuda",
                                                                        dtype=dtype)

    def bn(t):
        return F.batch_norm(t, mean, var, None, b, False, 0.0, 1e-5)

    out = {
        "conv": (lambda: F.conv2d(x, w, None, *args), None),
        "conv_bn": (lambda: bn(F.conv2d(x, w, None, *args)), None),
        "conv_bn_relu": (lambda: F.relu(bn(F.conv2d(x, w, None, *args))), None),
        "conv_bn_add": (lambda: bn(F.conv2d(x, w, None, *args)) + z, None),
        "conv_bn_add_relu": (lambda: F.relu(bn(F.conv2d(x, w, None, *args)) + z), None),
        "cudnn_relu": (lambda: torch.cudnn_convolution_relu(x, w, b, *args), "relu"),
        "cudnn_add_relu": (lambda: torch.cudnn_convolution_add_relu(x, w, z, 1.0, b, *args),
                           "add_relu"),
    }
    if conv.kernel_size == (1, 1) and conv.stride == (1, 1) and conv.groups == 1:
        rows = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        zrows = z.permute(0, 2, 3, 1).reshape(-1, c)
        wt = w.view(c, -1).t()
        out.update({
            "gemm": (lambda: rows @ wt, None),
            "gemm_bias": (lambda: torch.addmm(b, rows, wt), "bias"),
            "gemm_bias_relu": (lambda: torch._addmm_activation(b, rows, wt), "relu"),
            "gemm_bias_add": (lambda: torch.addmm(b, rows, wt).add_(zrows), "add"),
            "gemm_add_bias": (lambda: torch.addmm(zrows, rows, wt).add_(b), "add"),
        })
    # the f32 answer of each fused form's epilogue, for rel_err
    ref = F.conv2d(x.float(), w.float(), b.float(), *args)
    want = {"relu": F.relu(ref), "add_relu": F.relu(ref + z.float()), "bias": ref,
            "add": ref + z.float()}
    return out, want


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest magnitude; (N*H*W, C) rows
    are taken as the channels-last image they are."""
    if got.dim() == 2:
        n, c, h, w = want.shape
        got = got.view(n, h, w, c).permute(0, 3, 1, 2)
    return float((got.float() - want).abs().max() / want.abs().max())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/probe_fold_forms.json")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--replays", type=int, default=10)
    args = parser.parse_args()
    smi = torch.cuda.get_device_name(0)
    result = {"device": smi, "networks": {}}
    for net, spec in NETWORKS.items():
        rows, table = [], defaultdict(lambda: defaultdict(float))
        for key, (conv, count, name, chosen) in sites(*spec).items():
            fns, want = forms(conv, key[0])
            epilogue = key[-1]
            row = {"key": key, "count": count, "name": name, "class": site_class(conv),
                   "epilogue": epilogue, "form": chosen, "forms": {}}
            for form, (fn, fused) in fns.items():
                entry = {"us": round(timed(fn, args.reps, args.replays), 2)}
                if fused is not None:
                    entry["rel_err"] = rel_err(fn(), want[fused])
                row["forms"][form] = entry
            rows.append(row)
            today, candidates = CANDIDATES[epilogue]
            cell = table[(row["class"], epilogue)]
            cell["sites"] += count
            for form in (today, *candidates):
                if form in row["forms"]:
                    cell[form] += row["forms"][form]["us"] * count
            cell["chosen: " + chosen] += row["forms"][chosen]["us"] * count
            print(net, count, name, key, {f: e["us"] for f, e in row["forms"].items()},
                  flush=True)
        result["networks"][net] = {"sites": rows, "table": [
            {"class": c, "epilogue": e, **{f: round(v, 1) for f, v in cell.items()}}
            for (c, e), cell in sorted(table.items())]}
        for r in result["networks"][net]["table"]:
            print(f"{net} {r['class']}, {r['epilogue']}: us a frame {r}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"{smi}: written {args.out}", flush=True)


if __name__ == "__main__":
    main()
