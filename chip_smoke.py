#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises, so the exit code is non-zero):

1. Setup: print the card's name and power limit, require CUDA, build every
   kernel of ``vision_semantic_segmentation_tpu_torch/csrc`` with ``nvcc``
   (one process per source, in parallel) and print the build seconds.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with its time, the plain version's time, a one-call
   PyTorch yardstick where one exists, and its least possible time
   (``bound_ms``: the larger of bytes / 3.35 TB/s and flops / 67 TFLOP/s f32,
   the H100 SXM data-sheet rates).
3. The main path at full width: DeepLabV3+ ResNeXt50-32x4d OS8 (19 classes,
   bf16, seeded random weights, BatchNorm statistics from one frame) over one window of 8 raw 1440x1920 frames
   with ``distortion='points'`` into the 5x2000x2000 grid (bucket 2**17),
   then ``finalize``.  Launch counts are zeroed just before and read just
   after.  The same window then runs with every wrapper's plain version
   swapped in, and the two grids and maps are compared.
4. Where the time goes: ``torch.profiler`` over one more frame, printing
   the device time of the costliest kernels and the device's busy share
   of that frame.

The last two lines are the kernel summary JSON and the device JSON; the
``nvidia-smi`` line comes before them.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import LABEL_COLORS, PCD_ORIGIN_OFFSET
from vision_semantic_segmentation_tpu_torch.ops import kernels as K
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise, fold, render
from vision_semantic_segmentation_tpu_torch.runtime import FusedFramePipeline, MappingReplay

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
          f"bound {b_ms * 1e3:.1f} us ({b_by})", flush=True)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def check_render(gen) -> dict:
    c, h, w = 5, 2000, 2000
    grid = torch.rand((c, h, w), generator=gen, device="cuda")
    grid[:, torch.rand((h, w), generator=gen, device="cuda") < 0.3] = 0.0
    colors = torch.from_numpy(render.pack_colors(LABEL_COLORS)).cuda()
    out = render.render_bev_map_fused(grid, LABEL_COLORS)
    ref = render.render_bev_map_plain(grid, colors)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version on {(out != ref).sum()} cells")
    if not bool((out != 0).any()):
        raise AssertionError("K1 rendered an all-black map")
    ms = cuda_ms(lambda: render.render_bev_map_fused(grid, LABEL_COLORS), 50)
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


def check_depthwise(gen) -> dict:
    h, w, c = 180, 240, 2048
    kernel = torch.randn((3, 3, 1, c), generator=gen, device="cuda")
    w9 = kernel.reshape(9, c).contiguous()
    x32 = torch.randn((1, h, w, c), generator=gen, device="cuda")
    xbf = x32.to(torch.bfloat16)
    errs, times, plain_times, lib_times = [], [], [], []
    for d in (12, 24, 36):
        got = depthwise.depthwise3x3_dilated(x32, kernel, d)
        ref = depthwise.depthwise3x3_dilated_plain(x32, w9, d)
        e32 = float((got - ref).abs().max())
        if e32 > 1e-4:
            raise AssertionError(f"K3 f32 d={d} max |err| {e32} > 1e-4")
        got = depthwise.depthwise3x3_dilated(xbf, kernel, d).float()
        acc = depthwise.depthwise3x3_dilated_plain(xbf.float(), w9, d)  # f32 sums
        ulp = torch.exp2(torch.floor(torch.log2(acc.abs().clamp_min(1e-30))) - 7)
        worst = float(((got - acc).abs() / ulp).max())
        if worst > 1.0:
            raise AssertionError(f"K3 bf16 d={d}: {worst} bf16 ulp from the f32 sum")
        plain_bf = depthwise.depthwise3x3_dilated_plain(xbf, w9, d).float()
        ebf = float((got - plain_bf).abs().max())
        errs.append(ebf)
        ms = cuda_ms(lambda: depthwise.depthwise3x3_dilated(xbf, kernel, d), 30)
        plain_ms = cuda_ms(lambda: depthwise.depthwise3x3_dilated_plain(xbf, w9, d), 3)
        x_nchw = xbf.permute(0, 3, 1, 2)  # channels-last NCHW view
        w_oihw = kernel.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        lib_ms = cuda_ms(
            lambda: F.conv2d(x_nchw, w_oihw, padding=d, dilation=d, groups=c), 30
        )
        print(f"  K3 d={d}: f32 err {e32} bf16 err vs plain {ebf} (<= {worst:.3f} ulp "
              f"of the f32 sum) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"conv2d {lib_ms:.4f} ms", flush=True)
        times.append(ms)
        plain_times.append(plain_ms)
        lib_times.append(lib_ms)
    # one entry per kernel: bf16 (the main path's dtype), averaged over the
    # three ASPP dilations
    return entry(
        "depthwise3x3_dilated", "vision_semantic_segmentation_tpu_torch/csrc/depthwise.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/depthwise.py:224", max(errs),
        float(np.mean(times)), float(np.mean(plain_times)), float(np.mean(lib_times)),
        2 * h * w * c * 2 + 9 * c * 4, 18 * h * w * c,
    )


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
    expected = {"depthwise3x3_dilated": 3 * WINDOW, "evidence_fold_add": WINDOW,
                "render_bev_map_fused": 1}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
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
    diff = float((grid - grid_plain).abs().max())
    mismatch = float((color_map != map_plain).any(-1).mean())
    print(f"kernels vs plain path: grid max |diff| {diff}, map mismatch {mismatch}", flush=True)
    if not torch.allclose(grid, grid_plain, atol=1e-3):
        raise AssertionError(f"grid differs from the plain path by {diff}")
    if mismatch > 1e-3:
        raise AssertionError(f"rendered map differs from the plain path on {mismatch} of cells")
    return pipeline, frames


def where_time_goes(pipeline: FusedFramePipeline, frames: dict, top: int = 12) -> None:
    """Device time by kernel over one frame step, from ``torch.profiler``.

    The frame's host-clock time is taken without the profiler first; the
    busy share is the summed kernel time over the profiled frame's wall time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = [frames[k][1] for k in ("image", "pcd", "valid", "position", "quaternion")]
    grid = pipeline.init_grid()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.step(grid, *args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.step(grid, *args)
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
        print("one frame: device time not measured (the profiler saw no kernels)", flush=True)
        return
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"one frame: {wall_ms:.2f} ms host clock ({profiled_ms:.2f} ms under the profiler), "
          f"{device_ms:.2f} ms device time in {sum(r[1] for r in rows)} kernels "
          f"(busy share {device_ms / profiled_ms:.3f} of the profiled frame)", flush=True)
    for us, count, name in rows[:top]:
        print(f"  {us / 1e3:8.3f} ms {us / 1e3 / device_ms:6.1%} x{count:<4d} {name[:110]}", flush=True)


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

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    entries = [check_render(gen), check_fold(gen, rng), check_depthwise(gen)]
    pipeline, frames = main_path(entries, smi)
    where_time_goes(pipeline, frames)

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
