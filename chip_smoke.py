#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --sweep    # setup, then the kernels' launch choices timed

Phases (any failure raises, so the exit code is non-zero):

1. Setup: print the card's name and power limit, require CUDA, build every
   kernel of ``vision_semantic_segmentation_tpu_torch/csrc`` with ``nvcc``
   (one process per source, in parallel) and print the build seconds.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time, a one-call
   PyTorch yardstick where one exists, and its least possible time
   (``bound_ms``: the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s f32,
   the H100 SXM data-sheet rates).
   K1, K3, K4 and P1/P2 must equal their plain versions exactly (K4 also
   equals K3 branch by branch), also on edge shapes (K1: W not a multiple
   of 4, an unaligned grid; K4: ragged phases, C = 20 on the scalar path,
   g = 1, one and eight branches, halo tiles, a cut halo; K3 and P1/P2:
   ragged phases, a partial channel group, sub-tiled phases at d = 1 and
   2, d = 64 and 200 on a small image, C = 20, an unaligned input).  A
   single-branch ASPP module must launch K3 once and equal its plain run.
   Each kernel line prints its share of the bound.  Then the variants,
   from the times those checks took: per ASPP dilation
   ``F.conv2d(groups=C)``, K3, P1 (which P2 "f32col" shares) and P2
   "slab" with the ratio of the two, and K4 against three K3 launches
   (the counterpart of scripts/probe_depthwise_hoist.py and
   scripts/probe_aspp_fused.py).
3. The main path at full width: DeepLabV3+ ResNeXt50-32x4d OS8 (19 classes,
   bf16, seeded random weights, BatchNorm statistics from one frame) over
   one window of 8 raw 1440x1920 frames with ``distortion='points'`` into
   the 5x2000x2000 grid (bucket 2**17), then ``finalize``.  Launch counts
   are zeroed just before and read just after: K4 8, K2 8, K1 1, every
   other kernel 0.  The same window then runs with every wrapper's plain
   version swapped in, and the two grids and maps are compared.
4. The online serving path at the same width and weights: a TopicBus fed 8
   frames alternating camera1/camera6, each with a pose and a velodyne-frame
   ``points_raw`` cloud, through (a) SegmentationNode -> MappingNode with
   UNDISTORT on and (b) FusedOnlineNode, then (c) one confidence-weighted
   FusedFramePipeline window.  Each run: 8 frames fused, none dropped, the
   same launch counts as the main path, frames/s, and grid and map against
   the same run on the plain path.  Outputs go to the git-ignored build/.
5. Where the time goes: ``torch.profiler`` over one more main-path frame
   (inputs already on the card) and one more FusedOnlineNode frame (frame
   and cloud from the host, through the bus), printing the device time of
   the costliest kernels and copies and the device's busy share of each.

The last two lines are the kernel summary JSON and the device JSON; the
``nvidia-smi`` line comes before them.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import LABEL_COLORS, PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.ops import kernels as K
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise, fold, render
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise_hoist as hoist
from vision_semantic_segmentation_tpu_torch.inference import SemanticSegmentation
from vision_semantic_segmentation_tpu_torch.runtime import (
    FusedFramePipeline,
    FusedOnlineNode,
    MappingNode,
    MappingReplay,
    SegmentationNode,
    TopicBus,
)

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
WINDOW = 8
IMAGE_HW = (1440, 1920)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, err, ms, plain_ms, library_ms, bytes_moved, flops):
    b_ms, b_by = bound(bytes_moved, flops)
    print(f"kernel {name}: max_abs_err {err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"library {library_ms if library_ms is None else round(library_ms, 4)} ms "
          f"bound {b_ms * 1e3:.1f} us ({b_by}), {b_ms / ms:.1%} of the bound", flush=True)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def render_grid(gen, c, h, w, offset=0):
    """A (c, h, w) f32 grid with 30 % unexplored cells; ``offset`` elements
    into a larger buffer (1: a grid that is not 16-byte aligned)."""
    buf = torch.rand((offset + c * h * w,), generator=gen, device="cuda")
    grid = buf[offset:].view(c, h, w)
    grid[:, torch.rand((h, w), generator=gen, device="cuda") < 0.3] = 0.0
    return grid


def render_exact(what, grid, palette) -> int:
    colors = torch.from_numpy(render.pack_colors(palette)).cuda()
    out = render.render_bev_map_fused(grid, palette)
    ref = render.render_bev_map_plain(grid, colors)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    print(f"  K1 {what}: max |err| {err} vs plain", flush=True)
    if err != 0:
        raise AssertionError(f"K1 {what} differs from its plain version on {(out != ref).sum()} cells")
    if not bool((out != 0).any()):
        raise AssertionError(f"K1 {what} rendered an all-black map")
    return err


def check_render(gen) -> dict:
    for c, h, w, offset in RENDER_EDGES:
        grid = render_grid(gen, c, h, w, offset)
        palette = LABEL_COLORS if c == len(LABEL_COLORS) else \
            np.random.default_rng(c).integers(0, 256, (c, 3))
        render_exact(f"{(c, h, w)} offset {offset * 4} bytes", grid, palette)
    c, h, w = 5, 2000, 2000
    grid = render_grid(gen, c, h, w)
    err = render_exact(f"{(c, h, w)}", grid, LABEL_COLORS)
    colors = torch.from_numpy(render.pack_colors(LABEL_COLORS)).cuda()
    # the kernel through its C entry point: the wrapper's host work per call
    # (about 40-60 us) can exceed the kernel's, and would set the time
    out = torch.empty((h, w), dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: render.KERNEL.launch(render.ptr(grid), render.ptr(colors), c, h, w,
                                              render.STRIP_ROWS, render.ptr(out)), 50)
    wrapper_ms = cuda_ms(lambda: render.render_bev_map_fused(grid, LABEL_COLORS), 50)
    print(f"  K1 through its wrapper, back to back: {wrapper_ms:.4f} ms per call", flush=True)
    plain_ms = cuda_ms(lambda: render.render_bev_map_plain(grid, colors), 5)
    return entry(
        "render_bev_map_fused", "vision_semantic_segmentation_tpu_torch/csrc/render.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/render.py:83", float(err),
        ms, plain_ms, None, (c + 1) * h * w * 4, 7 * c * h * w,
    )


def check_fold(gen, rng) -> dict:
    c, h, w = 5, 2000, 2000
    grid = torch.randn((c, h, w), generator=gen, device="cuda")
    obs = (torch.rand((c, h, w), generator=gen, device="cuda") < 0.05).float()
    evidence = rng.standard_normal((c, c)).astype(np.float32)
    got = fold.evidence_fold_add_(grid.clone(), obs, evidence)
    ref = fold.evidence_fold_add_plain(grid.clone(), obs, evidence)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if err > 1e-5:
        raise AssertionError(f"K2 max |err| {err} > 1e-5")
    scratch = grid.clone()
    e_dev = torch.from_numpy(evidence).cuda()
    ms = cuda_ms(lambda: fold.evidence_fold_add_(scratch, obs, evidence), 50)
    plain_ms = cuda_ms(lambda: fold.evidence_fold_add_plain(scratch, obs, evidence), 5)
    library_ms = cuda_ms(
        lambda: torch.addmm(grid.view(c, -1), e_dev, obs.view(c, -1)), 20
    )
    return entry(
        "evidence_fold_add", "vision_semantic_segmentation_tpu_torch/csrc/fold.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/fold.py:43", err,
        ms, plain_ms, library_ms, 3 * c * h * w * 4, 2 * c * c * h * w,
    )


RENDER_EDGES = [  # (C, H, W, offset in f32 elements into a larger buffer)
    (5, 37, 53, 0),     # W % 4 != 0: scalar loads
    (5, 130, 2002, 0),  # W % 4 != 0, several strips and blocks across
    (5, 64, 200, 1),    # a grid 4 bytes into its buffer: not 16-byte aligned
    (11, 64, 200, 0),   # more channels than the kernel holds at once: two chunks
]
ASPP_SHAPE = (180, 240, 2048)   # (H, W, C) of the OS8 ASPP input at 1440x1920
ASPP_DILATIONS = (12, 24, 36)
ASPP_EDGES = [  # ((1, H, W, C), dilations, shared-memory budget of the plan or None)
    ((1, 37, 53, 72), (12, 24, 36), None),   # ragged phases, a partial channel group
    ((1, 37, 53, 20), (12, 24, 36), None),   # C % 8 != 0: one channel per thread
    ((1, 45, 60, 256), (5, 7), None),        # g = 1: halo tiles
    ((1, 20, 28, 40), (3,), None),           # one branch
    ((1, 21, 30, 16), (2, 4, 6, 8, 10, 12, 14, 16), None),  # eight branches
    ((1, 40, 44, 16), (1, 30), 4096),        # a cut halo: far taps from device memory
]
HOIST_KINDS = {  # kernel name -> (calls that launch it, TPU kernel it replaces)
    "hoisted": ((lambda x, k, d: hoist.hoisted(x, k, d),
                 lambda x, k, d: hoist.hoisted_variant(x, k, d, "f32col")),
                "scripts/probe_depthwise_hoist.py:61"),
    "hoisted_variant_slab": ((lambda x, k, d: hoist.hoisted_variant(x, k, d, "slab"),),
                             "scripts/probe_depthwise_hoist.py:119"),
}

# the three phase-walker kernels: kernel name -> (CudaKernel, its wrapper, plain version)
WALKERS = {
    "depthwise3x3_dilated": (depthwise.KERNEL, depthwise.depthwise3x3_dilated,
                             depthwise.depthwise3x3_dilated_plain),
    "hoisted": (hoist.HOISTED, hoist.hoisted, hoist.hoisted_plain),
    "hoisted_variant_slab": (hoist.VARIANTS["slab"], HOIST_KINDS["hoisted_variant_slab"][0][0],
                             hoist.hoisted_plain),
}
WALKER_EDGES = [  # ((1, H, W, C), dilation, arguments of the plan or None for the wrapper's)
    ((1, 37, 53, 72), 12, dict(group_bytes=64)),  # ragged phases, a partial channel group
    ((1, 37, 53, 72), 24, None),
    ((1, 37, 53, 20), 36, None),                  # C = 20: one channel per thread
    ((1, 45, 60, 256), 5, None),
    ((1, 20, 28, 40), 3, None),
    ((1, 21, 30, 16), 16, None),
    ((1, 40, 44, 16), 30, None),                  # d > W / 2: phases of two pixels
    ((1, *ASPP_SHAPE), 1, None),                  # one 180x240 phase: sub-tiles
    ((1, *ASPP_SHAPE), 2, None),
    ((1, 20, 28, 40), 64, None),                  # d > H and W: phases of one pixel
    ((1, 20, 28, 40), 200, None),
    ((1, *ASPP_SHAPE), 12, dict(smem_budget=8 * 1024)),  # a small budget: sub-tiles
]


def aspp_inputs(gen):
    """The ASPP input and one depthwise kernel per dilation, shared by the
    K3, K4 and P checks so that each time is taken on the same tensors."""
    h, w, c = ASPP_SHAPE
    kernels = [torch.randn((3, 3, 1, c), generator=gen, device="cuda") for _ in ASPP_DILATIONS]
    x32 = torch.randn((1, h, w, c), generator=gen, device="cuda")
    return kernels, x32, x32.to(torch.bfloat16)


def grouped_conv(x_nhwc, kernel, d):
    """One ``F.conv2d(groups=C)`` on the channels-last NCHW view (the yardstick)."""
    c = x_nhwc.shape[-1]
    w_oihw = kernel.permute(3, 2, 0, 1).to(x_nhwc.dtype).contiguous()
    return F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_oihw, padding=d, dilation=d, groups=c)


def walker_exact(name: str, what: str, x, w9, d, plan_args=None) -> None:
    """K3, ``hoisted`` or ``hoisted_variant_slab`` (the wrapper, or a given
    plan) against its plain version: exact."""
    kernel, call, plain = WALKERS[name]
    if plan_args is None:
        got = call(x, w9.reshape(3, 3, 1, -1), d)
    else:
        _, h, w, c = x.shape
        plan = depthwise.depthwise_plan(h, w, c, d, x.element_size(),
                                        hoist.staged_itemsize(kernel, x),
                                        aligned=depthwise.pointers_aligned(x, w9), **plan_args)
        got = depthwise.launch_depthwise(kernel, x, w9, d, plan)
    ref = plain(x, w9, d)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    if err != 0.0 or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name} {what} {x.dtype} d={d} differs from plain by {err}")


def check_walker_edges(name: str) -> None:
    """K3 or a P kernel on the edge shapes, f32 and bf16, and on a bf16
    input 2 bytes into its buffer: exact."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, d, plan_args in WALKER_EDGES:
        x = torch.randn(shape, generator=gen, device="cuda")
        w9 = torch.randn((9, shape[-1]), generator=gen, device="cuda")
        for xt in (x, x.to(torch.bfloat16)):
            walker_exact(name, f"{shape} plan {plan_args}", xt, w9, d, plan_args)
    shape = (1, 37, 53, 72)
    buf = torch.randn((1 + int(np.prod(shape)),), generator=gen, device="cuda").to(torch.bfloat16)
    walker_exact(name, f"{shape} input 2 bytes into its buffer", buf[1:].view(shape),
                 torch.randn((9, 72), generator=gen, device="cuda"), 12)
    print(f"  {name}: max |err| 0 vs plain on {len(WALKER_EDGES) + 1} edge shapes "
          f"(f32 and bf16; d = {sorted({e[1] for e in WALKER_EDGES})})", flush=True)


def check_depthwise(inputs, table: dict) -> dict:
    """K3 against its plain version: exact, f32 and bf16, on the main shape
    and the edge shapes; fills ``table[d]`` with the bf16 ms of K3 and of
    ``F.conv2d(groups=C)``, which the K4 and P entries reuse."""
    h, w, c = ASPP_SHAPE
    kernels, x32, xbf = inputs
    check_walker_edges("depthwise3x3_dilated")
    plain_times = []
    for kernel, d in zip(kernels, ASPP_DILATIONS):
        w9 = kernel.reshape(9, c).contiguous()
        for x in (x32, xbf):
            walker_exact("depthwise3x3_dilated", f"{(1, *ASPP_SHAPE)}", x, w9, d)
        # the bf16 result is the f32 sum of the bf16 inputs, rounded once
        got = depthwise.depthwise3x3_dilated(xbf, kernel, d)
        f32_sum = depthwise.depthwise3x3_dilated(xbf.float(), kernel, d)
        if not torch.equal(got, f32_sum.to(torch.bfloat16)):
            raise AssertionError(f"K3 bf16 d={d} is not the rounded f32 sum")
        row = table.setdefault(d, {})
        row["conv2d"] = cuda_ms(lambda: grouped_conv(xbf, kernel, d), 20)
        row["K3"] = cuda_ms(lambda: depthwise.depthwise3x3_dilated(xbf, kernel, d), 30)
        plain_times.append(cuda_ms(lambda: depthwise.depthwise3x3_dilated_plain(xbf, w9, d), 3))
        print(f"  K3 d={d}: max |err| 0 vs plain (f32 and bf16) kernel {row['K3']:.4f} ms "
              f"plain {plain_times[-1]:.4f} ms conv2d {row['conv2d']:.4f} ms", flush=True)
    # one entry per kernel: bf16 (the main path's dtype), averaged over the
    # three ASPP dilations
    return entry(
        "depthwise3x3_dilated", "vision_semantic_segmentation_tpu_torch/csrc/depthwise.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/depthwise.py:224", 0.0,
        float(np.mean([table[d]["K3"] for d in ASPP_DILATIONS])), float(np.mean(plain_times)),
        float(np.mean([table[d]["conv2d"] for d in ASPP_DILATIONS])),
        2 * h * w * c * 2 + 9 * c * 4, 18 * h * w * c,
    )


def check_single_branch_aspp() -> None:
    """The module route into K3: a full-width ASPP with one atrous branch
    launches K3 once (and K4 never) and equals its run on the plain path."""
    from vision_semantic_segmentation_tpu_torch.models.aspp import ASPP

    torch.manual_seed(4)
    aspp = ASPP(2048, atrous_channels=(256, 256), atrous_kernel_size=(1, 3),
                atrous_dilation=(1, 12)).to(device="cuda", dtype=torch.bfloat16).eval()
    h, w, c = ASPP_SHAPE
    x = torch.randn((1, c, h, w), device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        K.reset_launch_counts()
        got = aspp(x)
        launches = {k.name: k.launches for k in K.kernels() if k.launches}
        with K.plain_versions():
            ref = aspp(x)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    print(f"  single-branch ASPP {tuple(x.shape)} bf16: launches {launches}, "
          f"max |err| {err} vs its plain run", flush=True)
    if launches != {"depthwise3x3_dilated": 1}:
        raise AssertionError(f"single-branch ASPP launched {launches}, expected K3 once")
    if err != 0.0 or not bool(torch.isfinite(got.float()).all()) or got.shape != (1, 256, h, w):
        raise AssertionError(f"single-branch ASPP differs from its plain run by {err}")


def aspp_exact(what, x, w9s, dils, budget=None) -> None:
    """K4 (the wrapper, or a plan with a smaller shared-memory budget)
    against its plain version: exact."""
    if budget is None:
        got = depthwise.aspp_depthwise3x3_multi(x, [k.reshape(3, 3, 1, -1) for k in w9s], dils)
    else:
        _, h, w, c = x.shape
        plan = depthwise.aspp_plan(h, w, c, dils, x.element_size(), smem_budget=budget)
        got = depthwise.launch_multi(x, w9s, dils, plan)
    plain = depthwise.aspp_depthwise3x3_multi_plain(x, w9s, dils)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, plain))
    print(f"  K4 {what} {x.dtype}: max |err| {err} vs plain", flush=True)
    if err != 0.0:
        raise AssertionError(f"K4 {what} {x.dtype} differs from plain by {err}")


def check_aspp(inputs, table: dict) -> dict:
    """K4 against its plain version and, branch by branch, against K3: exact;
    also on the edge shapes, the main shape with halo tiles and an input
    that is not 16-byte aligned."""
    h, w, c = ASPP_SHAPE
    kernels, x32, xbf = inputs
    w9s = torch.stack([k.reshape(9, c) for k in kernels])
    dils = list(ASPP_DILATIONS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape, edge_dils, budget in ASPP_EDGES:
        x = torch.randn(shape, generator=gen, device="cuda")
        edge_w9s = torch.randn((len(edge_dils), 9, shape[-1]), generator=gen, device="cuda")
        for xt in (x, x.to(torch.bfloat16)):
            aspp_exact(f"{shape} d {edge_dils} budget {budget}", xt, edge_w9s, edge_dils, budget)
    for xt in (x32, xbf):
        aspp_exact(f"{(1, *ASPP_SHAPE)} halo tiles", xt, w9s, dils, budget=24 * 1024)
    shape = (1, 37, 53, 72)
    buf = torch.randn((1 + int(np.prod(shape)),), generator=gen, device="cuda").to(torch.bfloat16)
    aspp_exact(f"{shape} input 2 bytes into its buffer", buf[1:].view(shape),
               torch.randn((3, 9, 72), generator=gen, device="cuda"), dils)
    for x in (x32, xbf):
        got = depthwise.aspp_depthwise3x3_multi(x, kernels, dils)
        plain = depthwise.aspp_depthwise3x3_multi_plain(x, w9s, dils)
        single = [depthwise.depthwise3x3_dilated(x, k, d) for k, d in zip(kernels, dils)]
        torch.cuda.synchronize()
        e_plain = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, plain))
        e_k3 = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, single))
        print(f"  K4 {x.dtype}: max |err| vs plain {e_plain}, vs K3 per branch {e_k3}", flush=True)
        if e_plain != 0.0 or e_k3 != 0.0:
            raise AssertionError(f"K4 {x.dtype} differs: {e_plain} from plain, {e_k3} from K3")
    ms = cuda_ms(lambda: depthwise.aspp_depthwise3x3_multi(xbf, kernels, dils), 30)
    plain_ms = cuda_ms(lambda: depthwise.aspp_depthwise3x3_multi_plain(xbf, w9s, dils), 3)
    # three K3 launches back to back, the work K4 replaces on the main path
    table["K4"] = ms
    table["3 x K3"] = cuda_ms(lambda: [depthwise.depthwise3x3_dilated(xbf, k, d)
                                       for k, d in zip(kernels, dils)], 30)
    lib_ms = sum(table[d]["conv2d"] for d in dils)  # one grouped conv per branch
    n = len(dils)
    return entry(
        "aspp_depthwise3x3_multi", "vision_semantic_segmentation_tpu_torch/csrc/aspp_depthwise.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/depthwise.py:162", 0.0,
        ms, plain_ms, lib_ms, (1 + n) * h * w * c * 2 + n * 9 * c * 4, n * 18 * h * w * c,
    )


def check_hoist(inputs, table: dict) -> list:
    """P1 and both kinds of P2 against ``hoisted_plain``: exact, f32 and bf16.

    ``hoisted`` and ``hoisted_variant(..., "f32col")`` launch one kernel:
    both calls are checked, the kernel is timed once.  Each kernel also
    runs the edge shapes.
    """
    h, w, c = ASPP_SHAPE
    kernels, x32, xbf = inputs
    plain_ms = {d: cuda_ms(lambda: hoist.hoisted_plain(xbf, k.reshape(9, c), d), 3)
                for k, d in zip(kernels, ASPP_DILATIONS)}
    out = []
    for name, (calls, replaces) in HOIST_KINDS.items():
        check_walker_edges(name)
        for kernel, d in zip(kernels, ASPP_DILATIONS):
            w9 = kernel.reshape(9, c)
            for call in calls:
                for x in (x32, xbf):
                    got = call(x, kernel, d)
                    ref = hoist.hoisted_plain(x, w9, d)
                    torch.cuda.synchronize()
                    err = float((got.float() - ref.float()).abs().max())
                    if err != 0.0:
                        raise AssertionError(f"{name} {x.dtype} d={d}: max |err| {err}")
            table[d][name] = cuda_ms(lambda: calls[0](xbf, kernel, d), 30)
        times = [table[d][name] for d in ASPP_DILATIONS]
        print(f"  {name}: max |err| 0 vs hoisted_plain ({len(calls)} call(s), f32 and bf16, "
              f"d = {ASPP_DILATIONS}); bf16 ms per dilation {[round(t, 4) for t in times]}",
              flush=True)
        out.append(entry(
            name, "vision_semantic_segmentation_tpu_torch/csrc/depthwise_hoist.cu", replaces, 0.0,
            float(np.mean(times)), float(np.mean(list(plain_ms.values()))),
            float(np.mean([table[d]["conv2d"] for d in ASPP_DILATIONS])),
            2 * h * w * c * 2 + 9 * c * 4, 18 * h * w * c,
        ))
    return out


def print_variants(table: dict) -> None:
    """The depthwise designs side by side, per dilation (the probes' counterpart).

    The port's form of scripts/probe_depthwise_hoist.py and
    scripts/probe_aspp_fused.py: bf16 at the ASPP shape, the CUDA-event times
    that the K3, K4 and P checks took above on one set of inputs.
    """
    print(f"variants (bf16 {ASPP_SHAPE}, ms per call):", flush=True)
    for d in ASPP_DILATIONS:
        row = table[d]
        print(f"  d={d}: " + "  ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"  slab / f32col {row['hoisted_variant_slab'] / row['hoisted']:.3f}", flush=True)
    k4, k3 = table["K4"], table["3 x K3"]
    print(f"  K4 {k4:.4f} ms against 3 x K3 {k3:.4f} ms (ratio {k4 / k3:.3f}, "
          f"{'faster' if k4 < k3 else 'slower'})", flush=True)


def check_launches(what: str, launches: dict) -> None:
    """One window of the serving paths: one K4 forward and one K2 fold per
    frame, one K1 finalize; K3 and the probe kernels stay off the path."""
    expected = {k.name: 0 for k in K.kernels()}
    expected.update({"aspp_depthwise3x3_multi": WINDOW, "evidence_fold_add": WINDOW,
                     "render_bev_map_fused": 1})
    if launches != expected:
        raise AssertionError(f"{what}: launch counts {launches} != expected {expected}")


def compare_with_plain(what: str, grid, color_map, grid_plain, map_plain) -> None:
    diff = float((grid - grid_plain).abs().max())
    mismatch = float((color_map != map_plain).any(-1).mean())
    print(f"{what}: kernels vs plain path: grid max |diff| {diff}, map mismatch {mismatch}",
          flush=True)
    if not torch.allclose(grid, grid_plain, atol=1e-3):
        raise AssertionError(f"{what}: grid differs from the plain path by {diff}")
    if mismatch > 1e-3:
        raise AssertionError(f"{what}: map differs from the plain path on {mismatch} of cells")
    if not bool(torch.isfinite(grid).all()) or float(grid.sum()) <= 0:
        raise AssertionError(f"{what}: grid not finite or empty (sum {float(grid.sum())})")
    if not (color_map.sum(-1) > 0).any():
        raise AssertionError(f"{what}: rendered map is all black")


def make_window(cfg, seed: int) -> dict:
    """One window of raw frames + clouds, with runtime/tuning.py's recipe:
    points over a 40 m span at a 100 m inset, vehicle behind it facing +x."""
    rng = np.random.default_rng(seed)
    bucket = int(cfg.MAPPING.POINT_BUCKET)
    (bx0, _), (by0, _) = cfg.MAPPING.BOUNDARY
    span = 40.0
    x0m = bx0 + 100.0 - float(PCD_ORIGIN_OFFSET[0])
    y0m = by0 + 100.0 - float(PCD_ORIGIN_OFFSET[1])
    xy = rng.uniform([[x0m], [y0m]], [[x0m + span], [y0m + span]], (WINDOW, 2, bucket))
    zi = rng.uniform([[-1.0], [0.0]], [[0.5], [20.0]], (WINDOW, 2, bucket))
    frames = {
        "image": rng.integers(0, 256, (WINDOW, *IMAGE_HW, 3), dtype=np.uint8),
        "pcd": np.concatenate([xy, zi], axis=1).astype(np.float32),
        "valid": np.ones((WINDOW, bucket), bool),
        "position": np.tile(np.float32([x0m - 6.0, y0m + span / 2.0, 0.0]), (WINDOW, 1)),
        "quaternion": np.tile(np.float32([0, 0, 0, 1]), (WINDOW, 1)),
    }
    return {k: torch.from_numpy(v).cuda() for k, v in frames.items()}


def calibrate_batchnorm(pipeline: FusedFramePipeline, frame_u8: torch.Tensor) -> None:
    """Set each BatchNorm's running statistics to those of one frame.

    With He-normal weights and identity BatchNorm, a random ResNeXt's logits
    are one per-class constant plus a tiny spatial term, so every pixel
    takes one (unmapped) class.  Normalised activations give the random
    network spatially varying classes, so the grid and map get evidence.
    The pooled ASPP branch sees a 1x1 input and keeps identity statistics.
    """
    model = pipeline.model
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # cumulative average: one batch sets the stats
            m.reset_running_stats()
    model.train()
    model.aspp.global_avg_pool.eval()
    pipeline.segment(frame_u8)
    model.eval()


def main_path(entries: list, smi: str) -> None:
    cfg = get_cfg_defaults()  # 5x2000x2000 grid at 0.1 m, bucket 2**17, ResNeXt50 OS8
    cfg.OUTPUT_DIR = str(REPO / "build" / "chip_smoke")
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    pipeline = FusedFramePipeline(cfg, compute_dtype=torch.bfloat16, distortion="points",
                                  device="cuda", generator=gen)
    replay = MappingReplay(cfg, engine=pipeline.engine)
    frames = make_window(cfg, seed=100)
    calibrate_batchnorm(pipeline, frames["image"][0])
    # warm-up (cuDNN algorithm choice, allocator) on a scratch grid
    pipeline.step(pipeline.init_grid(), frames["image"][0], frames["pcd"][0],
                  frames["valid"][0], frames["position"][0], frames["quaternion"][0])
    torch.cuda.synchronize()
    print(f"main path set-up {time.perf_counter() - t0:.1f} s", flush=True)

    grid = pipeline.init_grid()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    grid = pipeline.run_window(grid, frames)
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    color_map = replay.finalize(grid, "chip_smoke")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in K.kernels()}
    print(f"main path launches {launches}", flush=True)
    check_launches("main path", launches)
    for e in entries:
        e["launches"] = launches[e["name"]]

    if not bool(torch.isfinite(grid).all()) or float(grid.sum()) <= 0:
        raise AssertionError(f"grid not finite or empty (sum {float(grid.sum())})")
    nonblack = float((color_map.sum(-1) > 0).mean())
    if nonblack <= 0:
        raise AssertionError("rendered map is all black")
    print(f"main path: {WINDOW / t_window:.3f} frames/s, {t_window / WINDOW * 1e3:.2f} ms/frame "
          f"(host clock, window of {WINDOW} at {IMAGE_HW[0]}x{IMAGE_HW[1]}, ResNeXt50 OS8 bf16, "
          f"2000x2000 grid) on {smi}; grid sum {float(grid.sum()):.1f}, "
          f"non-black cells {nonblack:.6f}", flush=True)

    with K.plain_versions():
        grid_plain = pipeline.run_window(pipeline.init_grid(), frames)
        map_plain = replay.finalize(grid_plain, "chip_smoke_plain")
    torch.cuda.synchronize()
    compare_with_plain("main path", grid, color_map, grid_plain, map_plain)
    return pipeline, frames


def make_online_feed(seed: int) -> list:
    """8 raw frames alternating camera1/camera6, each with a pose and a
    ``points_raw`` cloud in the velodyne frame: 10**5 points 5-45 m ahead,
    +-20 m to the sides, at road height."""
    rng = np.random.default_rng(seed)
    n = 100_000
    feed = []
    for i in range(WINDOW):
        xyz = rng.uniform([[5.0], [-20.0], [-2.0]], [[45.0], [20.0], [0.5]], (3, n))
        intensity = rng.uniform(0.0, 20.0, (1, n))
        feed.append({
            "stamp": 1.0 + i, "camera": ("camera1", "camera6")[i % 2],
            "image": rng.integers(0, 256, (*IMAGE_HW, 3), dtype=np.uint8),
            "cloud": np.concatenate([xyz, intensity]).astype(np.float32),
            "pose": (np.float64([0.0, 0.0, 0.0]), np.float64([0.0, 0.0, 0.0, 1.0])),
        })
    return feed


def publish_feed(bus: TopicBus, feed: list) -> None:
    for f in feed:
        bus.publish("/points_raw", f["cloud"], stamp=f["stamp"], frame_id="velodyne")
        bus.publish("/current_pose", f["pose"], stamp=f["stamp"])
        bus.publish(f"/{f['camera']}/image_raw", f["image"], stamp=f["stamp"],
                    frame_id=f["camera"])


def online_cfg():
    """The default configuration in points_raw mode.  The clouds are in the
    velodyne frame, whose cells (x + PCD_ORIGIN_OFFSET) the default boundary
    does not cover, so the 2000x2000 grid at 0.1 m moves to cover them."""
    cfg = get_cfg_defaults()
    cfg.MAPPING.DEPTH_METHOD = "points_raw"
    cfg.MAPPING.BOUNDARY = [[1300, 1500], [480, 680]]
    cfg.TEST_END_TIME = 1e12  # finalize explicitly, after the timed window
    cfg.OUTPUT_DIR = str(REPO / "build" / "chip_smoke_online")
    assert cfg.VISION_SEM_SEG.UNDISTORT and cfg.VISION_SEM_SEG.IMAGE_SCALE == 1.0
    return cfg


def online_run(what: str, make_node, feed: list, smi: str):
    """Feed the bus through a fresh node topology; time the 8 frames, then
    finalize.  Returns (grid, map, launches)."""
    bus = TopicBus()
    node = make_node(bus)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    publish_feed(bus, feed)
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    color_map = node.finalize()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in K.kernels()}
    if node.fused_frames != WINDOW or node.dropped_frames != 0:
        raise AssertionError(f"{what}: fused {node.fused_frames}, dropped {node.dropped_frames}")
    print(f"{what}: fused {node.fused_frames} dropped {node.dropped_frames}, "
          f"{WINDOW / t_window:.3f} frames/s ({t_window / WINDOW * 1e3:.2f} ms/frame, host "
          f"clock, bus publish to grid) on {smi}; launches {launches}", flush=True)
    return node.grid, color_map, launches


def online_phase(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """The online serving path at full width, each run against its plain path.

    (a) SegmentationNode -> MappingNode with UNDISTORT on (the 'image'
    undistortion in the segmentation node); (b) FusedOnlineNode; (c) one
    confidence-weighted FusedFramePipeline window.  All share the main
    path's seeded, BatchNorm-calibrated weights.
    """
    cfg = online_cfg()
    net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    state = pipeline.model.state_dict()
    feed = make_online_feed(seed=200)

    def two_node(bus):
        predictor = SemanticSegmentation(net_cfg, state_dict=state,
                                         compute_dtype=torch.bfloat16, device="cuda")
        SegmentationNode(cfg, bus, predictor=predictor)
        return MappingNode(cfg, bus, device="cuda")

    def fused_node(bus):
        return FusedOnlineNode(cfg, bus, state_dict=state, device="cuda")

    for what, make_node in (("online two-node", two_node), ("online fused node", fused_node)):
        online_run(what + " warm-up", make_node, feed, smi)
        grid, color_map, launches = online_run(what, make_node, feed, smi)
        check_launches(what, launches)
        with K.plain_versions():
            grid_plain, map_plain, _ = online_run(what + " (plain)", make_node, feed, smi)
        compare_with_plain(what, grid, color_map, grid_plain, map_plain)

    what = "confidence-weighted window"
    conf = FusedFramePipeline(pipeline.cfg, state_dict=state, compute_dtype=torch.bfloat16,
                              distortion="points", confidence_weighting=True, device="cuda")
    replay = MappingReplay(conf.cfg, engine=conf.engine)
    conf.run_window(conf.init_grid(), {k: v[:2] for k, v in frames.items()})  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    grid = conf.run_window(conf.init_grid(), frames)
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    color_map = replay.finalize(grid, "chip_smoke_confidence")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in K.kernels()}
    print(f"{what}: {WINDOW / t_window:.3f} frames/s ({t_window / WINDOW * 1e3:.2f} ms/frame) "
          f"on {smi}; launches {launches}", flush=True)
    check_launches(what, launches)
    with K.plain_versions():
        grid_plain = conf.run_window(conf.init_grid(), frames)
        map_plain = replay.finalize(grid_plain, "chip_smoke_confidence_plain")
    torch.cuda.synchronize()
    compare_with_plain(what, grid, color_map, grid_plain, map_plain)
    unweighted = pipeline.run_window(pipeline.init_grid(), frames)
    if torch.allclose(grid, unweighted):
        raise AssertionError(f"{what}: the confidences changed no evidence")


def where_time_goes(what: str, step, top: int = 12) -> None:
    """Device time by kernel over one call of ``step``, from ``torch.profiler``.

    The call's host-clock time is taken without the profiler first; the
    busy share is the summed device time over the profiled call's wall time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # operator rows repeat their kernels' time
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    if not rows:
        print(f"{what}: device time not measured (the profiler saw no kernels)", flush=True)
        return
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"{what}: {wall_ms:.2f} ms host clock ({profiled_ms:.2f} ms under the profiler), "
          f"{device_ms:.2f} ms device time in {sum(r[1] for r in rows)} kernels and copies "
          f"(busy share {device_ms / profiled_ms:.3f} of the profiled call)", flush=True)
    for us, count, name in rows[:top]:
        print(f"  {us / 1e3:8.3f} ms {us / 1e3 / device_ms:6.1%} x{count:<4d} {name[:110]}", flush=True)


def sweep(smi: str) -> None:
    """Launch choices at the main path's shapes, each checked against the
    default's output and timed with CUDA events on one set of inputs: K4's
    channel group and threads per block (bf16, d 12/24/36), the same two
    for K3, P1/"f32col" and "slab" per dilation, K1's strip rows
    (5x2000x2000)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    h, w, c = ASPP_SHAPE
    x = torch.randn((1, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    w9s = torch.randn((len(ASPP_DILATIONS), 9, c), generator=gen, device="cuda")
    kernels = [k.reshape(3, 3, 1, c) for k in w9s]
    want = depthwise.aspp_depthwise3x3_multi(x, kernels, ASPP_DILATIONS)
    k3 = cuda_ms(lambda: [depthwise.depthwise3x3_dilated(x, k, d)
                          for k, d in zip(kernels, ASPP_DILATIONS)], 30)
    print(f"sweep on {smi}: K4 bf16 {ASPP_SHAPE}; 3 x K3 {k3:.4f} ms", flush=True)
    for group_bytes in (64, 128, 256):
        for threads in (64, 128, 256):
            plan = depthwise.aspp_plan(h, w, c, ASPP_DILATIONS, 2, group_bytes=group_bytes,
                                       threads=threads)
            got = depthwise.launch_multi(x, w9s, ASPP_DILATIONS, plan)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = cuda_ms(lambda: depthwise.launch_multi(x, w9s, ASPP_DILATIONS, plan), 30)
            print(f"  K4 group {plan.group} threads {plan.threads} smem {plan.smem}: {ms:.4f} ms "
                  f"equal {same}", flush=True)
    for name, (kernel, call, _) in WALKERS.items():
        staged = hoist.staged_itemsize(kernel, x)
        for w9, d in zip(w9s, ASPP_DILATIONS):
            want = call(x, w9.reshape(3, 3, 1, c), d)
            plan = depthwise.depthwise_plan(h, w, c, d, 2, staged)
            ms = cuda_ms(lambda: depthwise.launch_depthwise(kernel, x, w9, d, plan), 30)
            print(f"  {name} d={d} default: group {plan.group} threads {plan.threads} "
                  f"smem {plan.smem}: {ms:.4f} ms", flush=True)
            for group_bytes in (64, 128, 256, 512):
                times = []
                for threads in (64, 128, 256):
                    plan = depthwise.depthwise_plan(h, w, c, d, 2, staged,
                                                    group_bytes=group_bytes, threads=threads,
                                                    smem_budget=depthwise.SMEM_LIMIT)
                    if not torch.equal(depthwise.launch_depthwise(kernel, x, w9, d, plan), want):
                        raise AssertionError(f"{name} d={d} {plan} differs from the default's output")
                    ms = cuda_ms(lambda: depthwise.launch_depthwise(kernel, x, w9, d, plan), 30)
                    times.append(f"{plan.threads} threads {ms:.4f} ms")
                print(f"  {name} d={d} group {plan.group} smem {plan.smem}: " + ", ".join(times)
                      + " (each equal to the default's output)", flush=True)
    grid = render_grid(gen, 5, 2000, 2000)
    want = render.render_bev_map_fused(grid, LABEL_COLORS)
    out = torch.empty((2000, 2000), dtype=torch.int32, device="cuda")
    colors = torch.from_numpy(render.pack_colors(LABEL_COLORS)).cuda()
    for strip in (4, 8, 16, 32, 64):
        def launch():
            render.KERNEL.launch(render.ptr(grid), render.ptr(colors), 5, 2000, 2000, strip,
                                 render.ptr(out))
        launch()
        same = torch.equal(out, want)
        ms = cuda_ms(launch, 50)
        print(f"  K1 strip {strip}: {ms:.4f} ms (C entry point) equal {same}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    seconds = K.build_all()
    print(f"kernel build {time.perf_counter() - t0:.1f} s {seconds}", flush=True)
    for k in K.kernels():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}", flush=True)
    if "--sweep" in sys.argv[1:]:
        sweep(smi)
        return

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    entries = [check_render(gen), check_fold(gen, rng)]
    inputs, table = aspp_inputs(gen), {}
    entries += [check_depthwise(inputs, table), check_aspp(inputs, table),
                *check_hoist(inputs, table)]
    del inputs
    check_single_branch_aspp()
    print_variants(table)
    pipeline, frames = main_path(entries, smi)
    online_phase(pipeline, frames, smi)

    args = [frames[k][1] for k in ("image", "pcd", "valid", "position", "quaternion")]
    grid = pipeline.init_grid()
    where_time_goes("one frame (main path, inputs on the card)", lambda: pipeline.step(grid, *args))
    bus = TopicBus()
    FusedOnlineNode(online_cfg(), bus, state_dict=pipeline.model.state_dict(), device="cuda")
    feed = make_online_feed(seed=300)[:3]
    publish_feed(bus, feed[:2])  # both cameras once
    where_time_goes("one online frame (FusedOnlineNode, frame and cloud from the host)",
                    lambda: publish_feed(bus, feed[2:]))

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
