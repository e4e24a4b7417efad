#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --sweep    # setup, then the kernels' launch choices timed
    python3 chip_smoke.py --training # setup, then phase 7 alone (development only:
                                     # no kernels line, no contract last line)

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
   (d) The planar ``DEPTH_METHOD`` with hull markers, two-node:
   ``SegmentationNode(publish_hulls=True)`` into a planar MappingNode over a
   5x2000x2000 grid at 0.02 m in front of the vehicle (BOUNDARY [[0, 40],
   [-20, 20]]), one ``/estimated_plane``, then 8 frames alternating the
   cameras with a moving pose: launches K4 8, K2 0, K1 1; the grid
   non-empty and equal to the plain path's; markers on both topics (one
   hull of each class also from a synthetic label map with known blobs),
   every point on the plane to 1e-3 m; frames/s.
5. The command line (``python -m vision_semantic_segmentation_tpu_torch``
   through ``main(argv)``, in this process) at the same width and weights,
   saved to ``build/chip_smoke_cli/weights.pth`` and named by a YAML
   overlay's ``MODEL.WEIGHT``.  The main path's 8 frames, clouds and poses
   are written as a ``.bag`` (12 Hz stamps) and an ``.npz`` with the port's
   writers.  (a) ``pipeline --fused`` over the bag: launches K4 8, K2 8,
   K1 1; its grid equals the main path's window, and its grid and written
   map equal the same run on the plain path; frames/s from the first
   decoded frame to the saved map.  (b) ``export`` of the bag equals the
   frames written.  (c) ``replay`` of an ``.npz`` of the main path's
   colourised labels (pre-segmented frames): launches K4 0, K2 8, K1 1,
   against the plain path, frames/s; then ``--save-grid`` over the first
   half and ``--resume-grid`` over the second equal one replay of both.
   (d) ``pipeline --rate 1`` over phase 4's feed written as a bag at 12 Hz,
   two-node and ``--fused``, each twice (the first run's executor threads
   pay their first use of the card): fused + dropped = 8, at least one fused, K2
   launches = frames fused, K4 = frames segmented, K1 1, no callback
   errors, a finite non-empty grid.  (e) The same with ``--decode-ahead``
   (the bag decoded on a worker thread), both topologies, each twice, same
   checks; then that bag with camera1's extrinsics on ``/tf`` at 0.5 s and
   moved at 1.3 s, 0.3 s after camera1's first frame, through
   ``run_online(fused=True, decode_ahead=True)``: the extrinsics registered
   for camera1 are the ones in force at that frame's stamp.  Each run's
   report is printed.
6. Where the time goes: ``torch.profiler`` over one more main-path frame
   (inputs already on the card), one more FusedOnlineNode frame (frame
   and cloud from the host, through the bus), one more planar two-node
   frame with hulls (phase 4(d) also times the planar update alone) and
   one more call each of
   ``pipeline --fused`` and ``replay``, printing the device time of the
   costliest kernels and copies and the device's busy share of each; and
   the fused CLI path's host steps (decode, staging, window, render, PNG)
   one at a time.

7. Training on the card (outputs under the git-ignored
   ``build/chip_smoke_train/``).  (a) ``DepthwiseBranches`` (K4 forward, K3
   on the flipped taps for dx, f32 wgrad) against autograd of the plain
   twin at ASPP's OS16 training shape (16 frames of 33x33x2048, d
   6/12/18), at the OS8 shape (65x65x2048, d 12/24/36) and on the
   single-branch K3 route, in f32 and bf16: the forward equal, dx and dW
   within the stated tolerances; and the time of dgrad and wgrad at the
   OS16 shape.  (b) ``main(["train", "--cfg", "configs/example_train.yaml",
   ...])`` at full width (DeepLabV3+ ResNeXt50-32x4d OS16, 19 classes,
   513x513 crops, batch 16, SGD, poly LR) over a Mapillary-layout dataset
   of 32 rendered 1440x1920 scene frames (PNG data under ``.jpg`` names)
   and 4 validation frames, 4 epochs (8 steps), in f32 and in bf16: finite
   loss whose last 4 steps average below its first 4, K4 16 and K3 48
   launches a step (K4 one more per validation frame), steps/s, images/s,
   peak memory, the host's wait for data against the step, and the card's
   busy share over one step; then AUTO_RESUME from the ``last_checkpoint``
   pointer at its saved step.  (c) The trained checkpoint through
   ``MODEL.WEIGHT`` into a ``FusedFramePipeline`` segmenting one
   full-width frame.  (d) The golden scene: ``train_segmenter`` (resnet18
   OS16 at 144x192, 8 train and 8 held-out views, at most 300 steps), then
   ``pipeline --fused`` over the 90-frame golden bag, scored against
   ``truth.npy`` with the floors of ``tests/test_e2e_golden.py`` (road 0.88,
   crosswalk 0.92, lane 0.80, mIoU 0.87).  Phase 7 starts by seeding the
   global CUDA generator with 12345 and drawing 2**26 dropout elements from
   it, which no earlier phase draws: the golden trainer seeds its own
   dropout, so its floors must hold whatever ran before.

8. The host-side commands at full width (outputs under the git-ignored
   ``build/chip_smoke_host/``; runs after phase 6 and before phase 7, on
   phase 3's network).  (a) ``profile_stages`` with phase 3's calibrated
   weights at 1440x1920, window 8, 2 windows, 2 repeats, ``distortion=
   'auto'`` (points): launches K4 80 (forward and e2e stages, warm-up
   windows included), K2 40, K1 0; NULL, forward, fusion and e2e ms and
   frames/s; then ``profile --window 8 --windows 1 --repeats 1 --json``
   once on random weights.  (b) ``video`` over phase 3's 8 frames as a
   1440x1920 MJPG, with a demo YAML naming phase 5's ``weights.pth``: K4 8,
   8 frames written at 1440x1920, decoded frames equal to the same command
   under the plain versions; the model FPS and cv2's MJPG encode and
   decode per frame.  (c) ``convert`` of phase 5's ``weights.pth``: a
   predictor loaded from the ``.npz`` gives the ``.pth`` predictor's labels
   on one frame.  (d) The off-path renderers (``mapping/renderer.py``) on
   phase 3's grid as (H, W, C), and ``stitch_image`` in both modes over
   three crops of it with shifted homographies: each equal to the same
   function on a CPU copy (uint8 exactly, floats within 1e-6), with its
   time on the card.

9. Int8 serving on phase 3's network (outputs under the git-ignored
   ``build/chip_smoke_int8/``; (a)-(c) and (e) run after phase 8, (d) after
   phase 7).  (a) Q1 (``csrc/int8_conv.cu``) against its plain version
   (an f64 conv of the int8 values, then the same f32 epilogue) at each
   3x3 site shape of the int8 ResNeXt50 at 1440x1920 (int8 out with ReLU,
   then bf16 out) and at a BasicBlock's two (resnet18 layer2_0: int8 out,
   bf16 and f32 out), then at the inner 4-band inputs of phase 13(c) at
   layer1 and layer4 and at a shape no output tile divides (int8, bf16 and
   f32 out), max |err| 0, each timed against the bf16 cuDNN conv of the
   same site and its bound (bytes / 3.35 TB/s or int8 operations / 1,979
   TOPS), both convs in the same two ways (CUDA events: 20 launched one by
   one, and 20 replayed from a CUDA graph, the device time without the
   host's launch cost); the kernels line gets a frame's 16 sites summed,
   launched one by one.  (b)
   ``main(["quantize", ...])`` over phase 5's bag with 8 calibration
   frames: 52 sites in the JAX package's format (tile-diagonal grouped
   kernels), no launch (calibration runs the float backbone alone).  (c) The
   two-node dataflow with ``MODEL.QPACK`` naming that qpack over phase 4's
   8 frames: launches K4 8, Q1 128, K2 8, K1 1; grid and map against the
   same run on the plain path; frames/s; the int8 forward against the bf16
   one on one frame (CUDA events), their label agreement (reported) beside
   a witness (the same agreement with the network in f32, calibrated in
   f32, and the float path's bf16-vs-f32 agreement, with the logits'
   relative RMS), and a profiler breakdown of the int8 forward.  (d) Phase 7(d)'s trained
   resnet18 quantized on 3 of the golden scene's frames at 144x192: labels
   equal to the f32 float path's on at least 0.97 of the pixels of 9
   frames.  (e) The C++ cloud decoder on phase 5's bag: equal to the numpy
   decoder, ms a cloud for both, and run (``native_io.calls``).

10. The serving tools (outputs under the git-ignored
   ``build/chip_smoke_serving/``; after phase 9(d), on phase 3's
   network rebuilt from phase 5's ``weights.pth`` and its window made
   again from its seed).  (a) Xception65 (``MODEL.TYPE "Xception"``, OS16,
   bf16, seeded weights, BatchNorm statistics from one frame) through
   ``FusedFramePipeline`` over a window of 8 raw 1440x1920 frames into the
   5x2000x2000 grid, then ``finalize``: its 60 stride-1 depthwise convs a
   frame counted by hooks, launches K3 480, K2 8, K1 1; grid and map against
   the same run on the plain path; frames/s, forward ms (CUDA events) and a
   profiler breakdown of one frame; then K3 against its plain version at
   each of the 9 distinct site shapes (f32 and bf16, max |err| 0), each
   timed in bf16 (the kernel from a CUDA graph of 30 launches through its
   C entry point, since a launch from the host costs more than the
   smallest sites' kernels; also through its wrapper) against
   ``F.conv2d(groups=C)``, the plain version and its bound; the kernels
   line's K3 entry is a frame's 60 sites summed, with (a)'s launches.  (b)
   ``main(["compile", ...])`` of phase 3's network at 1440x1920, window 8
   (export seconds), ``load_sequence_runner`` with its state dict (load
   seconds; the artifact smaller than the state dict), one window: K4 8,
   K2 8, the grid updated in place and equal to ``run_window``'s to 1e-3;
   frames/s of both; a window of 7 refused.  (c) ``main(["autotune",
   ...])`` at 1440x1920 over update windows of 1100 (lossy: 2200 cells
   needed) and 0: 2 rows, a lossy row never best, the overlay merged into
   a config that runs a window; then that window under FOLD_METHOD
   'scatter', SORT_METHOD 'radix': K2 8, the grid bit-equal.  (d)
   ``main(["autotune", "--serving", "--no-quality", ...])`` at 8 points
   (ResNeXt50 and ResNet-50, OS 8 and 16, scales 1.0 and 0.5) at
   1440x1920, then quality at ResNet-50 OS16 scale 0.1 on the golden scene
   (at most 300 training steps): not partial, a recommended point, the
   overlay and the JSON written.

11. Parallel replay (``parallel/``; outputs under the git-ignored
   ``build/chip_smoke_parallel/``; after phase 10) over phase 5's 8 pre-segmented
   1440x1920 frames (bucket 2**17, the 5x2000x2000 grid) against phase 5's
   sequential ``replay`` grid (within 1e-3, maps on at most 1e-3 of the
   cells).  Logical shards are one card repeated in the mesh; they run one
   after another.  Each run's launches are counted alone.  (a)
   ``main(["replay", "--frame-parallel", ...])`` on the card's own mesh of
   one device: K2 8, K1 1; ``--save-grid``/``--resume-grid`` over two halves
   equal one run.  (b) ``run_frames_parallel`` over 4 and 3 logical shards
   (3 pads one no-op frame): K2 8 and 9, each also against its own plain
   run.  (c) ``MAPPING.GRID_SHARDS 4`` sequential replay over 4 logical
   shards, without a window and with ``UPDATE_WINDOW`` 1100 (slabs straddle
   the bands): K2 32, each grid against the unsharded replay at its
   configuration (within 1e-4), the bands' shapes and bytes.  (d)
   ``frame_parallel`` with ``GRID_SHARDS 2`` over a (2, 2) mesh: K2 16.  (e)
   The full-route 5x5000x7000 grid (0.2 m, ``UPDATE_WINDOW`` 512) in 4
   bands of 175 MB against the unsharded engine at that configuration
   (within 1e-4).  Frames/s of each, host clock, synchronised at both ends:
   the counted run, then (b)-(e) three more.

12. Data-parallel training (``parallel/distributed.py``, the data-parallel
   steps, ``train --distributed``; outputs under the git-ignored
   ``build/chip_smoke_dp/``), on phase 7's rendered dataset.  The
   phase starts two ranks on cuda:0 (``chip_smoke.py
   --rank-worker spec.json``, each with a time limit; a failing rank fails
   the phase) and opens their gloo group itself: NCCL refuses two ranks on
   one card, and two ranks on one card measure the rank machinery, not
   multi-card speed.  (a) One global-batch step of ``example_train.yaml``
   at full width (ResNeXt50-32x4d OS16, 19 classes, f32, TF32 off, no
   dropout, 16 centre crops of 513x513 as 2 x 8) against the one-process
   step on the same 16: the loss, the confusion, the largest parameter
   and running-statistic differences (tolerances, and why, at
   ``DP_LOSS_RTOL``); the per-device step on identical halves against the
   global-batch step; K4 8 and K3 24 a rank; the gradient all-reduce's ms.
   (b) ``main(["train", "--distributed", ...])`` on the two ranks with
   ``example_train.yaml`` as it stands (per-device BatchNorm, K = 8) for 4
   epochs, resumed by AUTO_RESUME for one more, then with ``MODEL.SYNC_BN
   True``: the loss falling, steps/s and images/s, each rank's peak memory
   and wait for data, launches, checkpoints written by rank 0 alone.  (c)
   ``torchrun --nproc-per-node 1 -m vision_semantic_segmentation_tpu_torch
   train --distributed``, a one-rank NCCL world, against the same command in
   this process: per-step losses within ``DP_TORCHRUN_RTOL``.

13. Spatial sharding (``parallel/spatial_infer.py``, ``MODEL.SPATIAL_SHARDS``,
   ``TRAIN.SPATIAL_SHARDS``; outputs under the git-ignored
   ``build/chip_smoke_spatial/``; after phase 12) on logical shards of
   cuda:0, which run one band after another: the phase measures the bands,
   halos and kernels, not multi-card speed.  Each run's launches are
   counted alone; tolerances, and why, at ``SPATIAL_LABEL_TOL``.  (a) Phase
   3's network (phase 5's ``weights.pth``), one raw 1440x1920 frame through
   ``SemanticSegmentation(devices=["cuda:0"] * 4)`` with
   ``MODEL.SPATIAL_SHARDS 4`` (45 rows a band at OS8, a 36-row halo for
   dilation 36) in bf16 and in f32, then 8 bands (22-23 rows, halos over
   two bands) in f32: labels and logits against the unsharded predictor,
   K4 4 (8) a frame, ms a frame against unsharded, peak memory, K4's rows
   read.  (b) ``SegmentationNode`` with the 4-band predictor ->
   ``MappingNode`` over phase 4's feed (K4 32, K2 8, K1 1) against the
   same dataflow unsharded.  (c) The 4-band predictor quantized on 2
   frames, served banded (Q1 64 a frame) against the unsharded predictor
   with its qpack.  (d) Xception65 OS16 bf16, seeded, 4 bands (K3 240 a
   frame) against unsharded.  (e) ``example_train.yaml`` with ``SYNC_BN
   True`` and ``TRAIN.SPATIAL_SHARDS 3`` (513-row crops), (data 1, spatial
   3), f32, no dropout, over phase 12(a)'s 16 centre crops: one step
   against the one-process step (loss, confusion, running statistics,
   parameters; K4 48, K3 144), the eval-mode gradient against the
   one-process one (held in f64 on the plain versions, f32 reported); ``Trainer(cfg, devices=["cuda:0"] * 3)`` for 4 steps
   (the loss falls; steps/s, images/s, peak memory); and ``main(["train",
   ..., "TRAIN.SPATIAL_SHARDS", "3"])`` on the one card raising the
   device-count ``ValueError``.

14. Bands across ranks (``TRAIN.SPATIAL_SHARDS`` under ``train
   --distributed``: ``World.spatial_groups``, the halo exchange and the
   banded reductions over ``torch.distributed``; outputs under the
   git-ignored ``build/chip_smoke_spatial_ranks/``; after phase 13, whose
   13(e) references it reads).  Phase 12's ``--rank-worker`` launcher starts
   the ranks on cuda:0 over gloo (NCCL refuses two ranks on one card): the
   phase measures the exchange machinery, not multi-card speed, and the
   NCCL point-to-point path waits for a four-chip run.  Rank r holds band
   ``r % 3`` of data group ``r // 3``.  (a) One step of 13(e)'s
   configuration on 3 ranks (data 1 x spatial 3, ``MODEL.SYNC_BN True``)
   against 13(e)'s one-process banded step (12(a)'s tolerances) and the
   unsharded step (13(e)'s envelope); K4 16 and K3 48 a rank; the
   collective calls a step, equal on every rank; the halo bytes a rank
   sends; the ms of the exchanges and of the all-reduces (the same step
   again, each call timed with the card synchronised around it); peak
   memory.  (b) The eval-mode gradient over 4 crops in f64 on the plain
   versions against 13(e)'s one-process one.  (c) ``main(["train",
   "--distributed", ..., "TRAIN.SPATIAL_SHARDS", "3"])`` on 6 ranks (data 2
   x spatial 3) for 4 steps: the loss falls, steps/s, images/s, each
   rank's wait for data, launches, checkpoints by rank 0 alone.  (d) The
   same command with ``TRAIN.SPATIAL_SHARDS 4`` raises the
   does-not-divide-the-world ``ValueError`` on every rank, each group within
   ``RANKS_TIMEOUT``.

A ``clock:`` line after each phase gives the seconds since the start.
The last two lines are the kernel summary JSON and the device JSON; the
``nvidia-smi`` line comes before them.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib.util
import json
import os
import re
import shutil
import signal
import socket
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults, get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.mapping import (
    LABEL_COLORS,
    PCD_ORIGIN_OFFSET,
    SemanticMappingEngine,
)
from vision_semantic_segmentation_tpu_torch.ops import kernels as K
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise, fold, render
from vision_semantic_segmentation_tpu_torch.ops.kernels import depthwise_hoist as hoist
from vision_semantic_segmentation_tpu_torch.__main__ import main as cli_main
from vision_semantic_segmentation_tpu_torch.inference import (
    SemanticSegmentation,
    colorize_labels,
    postprocess_labels,
)
from vision_semantic_segmentation_tpu_torch.evaluation import synthetic_scene as scene
from vision_semantic_segmentation_tpu_torch.evaluation.map_eval import MapEvaluator
from vision_semantic_segmentation_tpu_torch.models import BatchNorm2d, build_model, build_train_model
from vision_semantic_segmentation_tpu_torch.models.loss import cross_entropy_loss
from vision_semantic_segmentation_tpu_torch.models.convert import load_weights
from vision_semantic_segmentation_tpu_torch.ops.colormap import MAPILLARY_19_PALETTE
from vision_semantic_segmentation_tpu_torch.ops.colormap import palette_from_cfg
from vision_semantic_segmentation_tpu_torch.ops.resize import resize_area
from vision_semantic_segmentation_tpu_torch.device import resolve_device
from vision_semantic_segmentation_tpu_torch.parallel import (
    TrainState,
    create_mesh,
    local_devices,
    make_per_device_bn_train_step,
    make_spatial_train_step,
    make_train_step,
    spatial_infer,
)
from vision_semantic_segmentation_tpu_torch.parallel.train_step import spatial_loss
from vision_semantic_segmentation_tpu_torch.parallel.distributed import (
    all_reduce_,
    ensure_distributed,
)
from vision_semantic_segmentation_tpu_torch.train.build import build_dataloader
from vision_semantic_segmentation_tpu_torch.train.checkpoint import Checkpoint
from vision_semantic_segmentation_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    build_scheduler,
)
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from vision_semantic_segmentation_tpu_torch.train.transforms import Compose, Normalize, ToTensor
from vision_semantic_segmentation_tpu_torch.utils import image_io
from vision_semantic_segmentation_tpu_torch.runtime import (
    FrameRecord,
    FusedFramePipeline,
    FusedOnlineNode,
    MappingNode,
    MappingReplay,
    SegmentationNode,
    TopicBus,
    load_frames,
    rosbag,
    save_frames,
)

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
WINDOW = 8
IMAGE_HW = (1440, 1920)


def has_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:  # the parent package is missing
        return False


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


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn`` per call, ``iters`` calls captured in one CUDA
    graph and replayed between CUDA events: the host's launch cost, which
    exceeds a kernel of a few microseconds, stays out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def check_launches(what: str, launches: dict, k4: int = WINDOW, k2: int = WINDOW,
                   k1: int = 1, q1: int = 0) -> None:
    """One window of the serving paths: by default one K4 forward and one K2
    fold per frame, one K1 finalize; K3, the probe kernels and Q1 (the int8
    backbone's, phase 9) stay off the path."""
    expected = {k.name: 0 for k in K.kernels()}
    expected.update({"aspp_depthwise3x3_multi": k4, "evidence_fold_add": k2,
                     "render_bev_map_fused": k1, "int8_conv3x3": q1})
    if launches != expected:
        raise AssertionError(f"{what}: launch counts {launches} != expected {expected}")


def compare_with_plain(what: str, grid, color_map, grid_plain, map_plain,
                       against: str = "the plain path") -> None:
    diff = float((grid - grid_plain).abs().max())
    mismatch = float((color_map != map_plain).any(-1).mean())
    print(f"{what}: against {against}: grid max |diff| {diff}, map mismatch {mismatch}",
          flush=True)
    if not torch.allclose(grid, grid_plain, atol=1e-3):
        raise AssertionError(f"{what}: grid differs from {against} by {diff}")
    if mismatch > 1e-3:
        raise AssertionError(f"{what}: map differs from {against} on {mismatch} of cells")
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


PLANE = (0.0, 0.0, 1.0, 1.9)  # the ground 1.9 m below the velodyne


def planar_cfg():
    """The default configuration in the planar DEPTH_METHOD over a grid in
    front of the vehicle: 40x40 m at 0.02 m, 5x2000x2000 as the default's."""
    cfg = get_cfg_defaults()
    cfg.MAPPING.DEPTH_METHOD = "planar"
    cfg.MAPPING.BOUNDARY = [[0, 40], [-20, 20]]
    cfg.MAPPING.RESOLUTION = 0.02
    cfg.TEST_END_TIME = 1e12  # finalize explicitly, after the timed window
    cfg.OUTPUT_DIR = str(REPO / "build" / "chip_smoke_planar")
    return cfg


def make_planar_feed(seed: int) -> list:
    """8 raw frames alternating camera1/camera6; the vehicle drives 0.5 m
    and turns 0.05 rad a frame."""
    rng = np.random.default_rng(seed)
    feed = []
    for i in range(WINDOW):
        yaw = 0.05 * i
        feed.append({
            "stamp": 1.0 + i, "camera": ("camera1", "camera6")[i % 2],
            "image": rng.integers(0, 256, (*IMAGE_HW, 3), dtype=np.uint8),
            "pose": (np.float64([0.5 * i, 0.1 * i, 0.0]),
                     np.float64([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])),
        })
    return feed


def synthetic_labels() -> np.ndarray:
    """A label map at the network's output resolution with one crosswalk
    (class 1) and one road (class 2) blob in the lower half."""
    labels = np.zeros((180, 240), np.int32)
    labels[120:160, 30:110] = 1
    labels[110:175, 130:230] = 2
    return labels


def check_markers(what: str, markers: dict) -> int:
    """Markers on both topics, every point on PLANE to 1e-3 m."""
    n = np.array(PLANE[:3]) / np.linalg.norm(PLANE[:3])
    d = PLANE[3] / np.linalg.norm(PLANE[:3])
    worst, count = 0.0, {}
    for topic, msgs in markers.items():
        count[topic] = sum(len(m) for m in msgs)
        for m in (m for msg in msgs for m in msg):
            worst = max(worst, float(np.abs(m.points @ n + d).max()))
    print(f"  {what}: markers {count}, worst distance to the plane {worst:.2e} m", flush=True)
    if min(count.values()) < 1 or worst >= 1e-3:
        raise AssertionError(f"{what}: markers {count}, worst distance {worst}")
    return sum(count.values())


def planar_run(what: str, state: dict, feed: list, smi: str):
    """SegmentationNode(publish_hulls=True) -> planar MappingNode: one plane,
    then the 8 frames, timed; finalize; then one synthetic hull of each
    class.  Returns (grid, map, launches, markers from the frames)."""
    cfg = planar_cfg()
    bus = TopicBus()
    predictor = SemanticSegmentation(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, state_dict=state,
                                     compute_dtype=torch.bfloat16, device="cuda")
    seg = SegmentationNode(cfg, bus, predictor=predictor, publish_hulls=True)
    node = MappingNode(cfg, bus, device="cuda")
    markers = {"/crosswalk_markers": [], "/road_markers": []}
    for topic, sink in markers.items():
        bus.subscribe(topic, lambda m, sink=sink: sink.append(m.data))
    bus.publish("/estimated_plane", list(PLANE), stamp=0.5)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for f in feed:
        bus.publish("/current_pose", f["pose"], stamp=f["stamp"])
        bus.publish(f"/{f['camera']}/image_raw", f["image"], stamp=f["stamp"],
                    frame_id=f["camera"])
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    color_map = node.finalize()
    launches = launches_now()
    from_frames = {t: sum(len(m) for m in msgs) for t, msgs in markers.items()}
    print(f"{what}: {WINDOW / t_window:.3f} frames/s ({t_window / WINDOW * 1e3:.2f} ms/frame, "
          f"host clock, bus publish to grid, hulls included) on {smi}; dropped "
          f"{node.dropped_frames}; hull markers from the frames {from_frames}; launches "
          f"{launches}", flush=True)
    for index in (1, 2):
        seg.generate_and_publish_convex_hull(synthetic_labels(), "camera1", index_care_about=index)
    check_markers(what, markers)
    return node.grid, color_map, launches


def planar_phase(pipeline: FusedFramePipeline, smi: str) -> None:
    """(d) The planar DEPTH_METHOD with hull markers, two-node, at full width."""
    state = pipeline.model.state_dict()
    feed = make_planar_feed(seed=400)
    what = "planar two-node with hulls"
    planar_run(what + " warm-up", state, feed, smi)
    grid, color_map, launches = planar_run(what, state, feed, smi)
    check_launches(what, launches, k2=0)
    with K.plain_versions():
        grid_plain, map_plain, _ = planar_run(what + " (plain)", state, feed, smi)
    compare_with_plain(what, grid, color_map, grid_plain, map_plain)
    print(f"  {what}: grid cells with evidence {int((grid > 0).sum())} of {grid.numel()}",
          flush=True)
    # the planar update alone: host DLT fit, warp, per-class adds and max
    engine = SemanticMappingEngine(planar_cfg(), device="cuda")
    image = torch.from_numpy(np.array(LABEL_COLORS, np.uint8)[
        np.random.default_rng(5).integers(0, len(LABEL_COLORS), IMAGE_HW)]).cuda()
    T = np.eye(4)
    scratch = engine.init_grid()
    device_ms = cuda_ms(lambda: engine.update_map_planar(scratch, image, T), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        engine.update_map_planar(scratch, image, T)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"  planar update alone ({IMAGE_HW[0]}x{IMAGE_HW[1]} image onto 5x2000x2000): "
          f"{device_ms:.3f} ms per call between CUDA events, {host_ms:.3f} ms host clock, "
          f"on {smi}", flush=True)


CLI = REPO / "build" / "chip_smoke_cli"
XYZI = [rosbag.PointField(f, 4 * i, 7, 1) for i, f in enumerate(("x", "y", "z", "intensity"))]


def read_png(path: Path) -> np.ndarray:
    """An RGB PNG as ``runtime/replay.py::write_png`` writes it (8 bits, no
    row filter, channels reversed), back as the array it was given: one
    reader for both sides of a comparison."""
    data, off, idat = path.read_bytes(), 8, b""
    while off < len(data):
        n, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        off += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise ValueError(f"{path}: a row filter this reader does not undo")
    return rows[:, 1:].reshape(h, w, 3)[..., ::-1]


def overlay(name: str, weights: Path, mapping: str = "", extra: str = "") -> str:
    """A YAML overlay naming the weights and a fresh output directory."""
    path = CLI / f"{name}.yaml"
    path.write_text(
        f"OUTPUT_DIR: '{CLI / 'out' / name}'\n{extra}"
        + (f"MAPPING:\n{mapping}" if mapping else "")
        + f"VISION_SEM_SEG:\n  SEM_SEG_NETWORK:\n    MODEL:\n      WEIGHT: '{weights}'\n")
    return str(path)


def written_map(name: str, file: str) -> np.ndarray:
    (path,) = (CLI / "out" / name).glob(f"version_*/{file}")
    return read_png(path)


def write_bag(path: Path, records) -> None:
    """(topic, message) per record with the records' header stamps, one
    chunk, through the port's writer."""
    rosbag.write_bag(str(path), [(t, m, m.header.stamp) for t, m in records])


def frame_messages(stamp: float, camera: str, image, cloud, frame_id, position, quaternion):
    header = rosbag.Header(0, stamp, frame_id)
    pts = np.ascontiguousarray(np.asarray(cloud, np.float32).T)
    return [
        ("/reduced_map" if frame_id == "world" else "/points_raw",
         rosbag.PointCloud2Msg(header, 1, pts.shape[0], XYZI, 16, pts.tobytes())),
        ("/current_pose", rosbag.PoseStampedMsg(rosbag.Header(0, stamp, "world"),
                                                np.float64(position), np.float64(quaternion))),
        (f"/{camera}/image_raw", rosbag.ImageMsg(rosbag.Header(0, stamp, camera),
                                                 *image.shape[:2], "rgb8", image)),
    ]


def launches_now() -> dict:
    torch.cuda.synchronize()
    return {k.name: k.launches for k in K.kernels()}


def cli_fused(pipeline: FusedFramePipeline, host: dict, weights: Path, smi: str) -> None:
    """(a) ``pipeline --fused`` over the main path's window as a .bag."""
    bag = CLI / "main_window.bag"
    K.reset_launch_counts()
    run = cli_main(["pipeline", "--cfg", overlay("fused", weights), "--bag", str(bag), "--fused"])
    launches = launches_now()
    print(f"CLI fused pipeline over a .bag: {run.frames} frames in {run.seconds:.3f} s, "
          f"{run.frames / run.seconds:.3f} frames/s (host clock, first decoded frame to the "
          f"saved map) on {smi}; launches {launches}", flush=True)
    check_launches("CLI fused pipeline", launches)
    color_map = written_map("fused", "global_map_fused.png")
    if run.frames != WINDOW or not np.array_equal(color_map, run.color_map):
        raise AssertionError(f"CLI fused pipeline: {run.frames} frames, or a written map "
                             "that is not the map it rendered")
    # the same frames straight from the card, with no bag, staging or stream
    direct = pipeline.run_window(pipeline.init_grid(),
                                 {k: torch.from_numpy(v).cuda() for k, v in host.items()})
    diff = float((run.grid - direct).abs().max())
    print(f"  CLI grid against the main path's window: max |diff| {diff}", flush=True)
    if not torch.allclose(run.grid, direct, atol=1e-3):
        raise AssertionError(f"CLI fused grid differs from the main path's by {diff}")
    with K.plain_versions():
        plain = cli_main(["pipeline", "--cfg", overlay("fused_plain", weights), "--bag",
                          str(bag), "--fused"])
    compare_with_plain("CLI fused pipeline", run.grid, color_map, plain.grid,
                       written_map("fused_plain", "global_map_fused.png"))


def cli_export(records: list) -> None:
    """(b) ``export`` of the bag: the frames written."""
    out = CLI / "exported.npz"
    cli_main(["export", str(CLI / "main_window.bag"), "--out", str(out)])
    back = load_frames(str(out))
    same = len(back) == len(records) and all(
        (a.camera, a.pcd_frame_id) == (b.camera, b.pcd_frame_id) and abs(a.stamp - b.stamp) < 1e-6
        and all(np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
                for k in ("pcd", "semantic_image", "position", "quaternion"))
        for a, b in zip(back, records))
    print(f"CLI export of the .bag: {len(back)} frames, equal to the frames written: {same}",
          flush=True)
    if not same:
        raise AssertionError("export of the .bag differs from the frames written")


def cli_replay(pipeline: FusedFramePipeline, records: list, weights: Path, smi: str) -> None:
    """(c) ``replay`` of pre-segmented frames: the main path's labels, coloured."""
    palette = palette_from_cfg(pipeline.cfg.VISION_SEM_SEG.SEM_SEG_NETWORK)
    segmented = []
    for f in records:
        logits = pipeline.segment(torch.from_numpy(f.semantic_image).cuda())
        labels = logits.argmax(1)[0].to(torch.int32)
        rgb = colorize_labels(postprocess_labels(labels, IMAGE_HW), palette).cpu().numpy()
        segmented.append(FrameRecord(**{**f.__dict__, "semantic_image": rgb}))
    dirs = {name: CLI / name for name in ("replay_all", "replay_first", "replay_second")}
    for name, part in (("replay_all", segmented), ("replay_first", segmented[:WINDOW // 2]),
                       ("replay_second", segmented[WINDOW // 2:])):
        dirs[name].mkdir()
        save_frames(part, str(dirs[name] / "labels.npz"))

    def replay(name, *args):
        return cli_main(["replay", "--cfg", overlay(name, weights), *args])

    grids = {}
    for name in ("replay", "replay_plain"):
        def run():
            return replay(name, "--input-dir", str(dirs["replay_all"]),
                          "--save-grid", str(CLI / f"{name}_grid.npz"))
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "replay":
            run()
            seconds = time.perf_counter() - t0
            launches = launches_now()
            print(f"CLI replay of {WINDOW} pre-segmented frames (.npz): {seconds:.3f} s, "
                  f"{WINDOW / seconds:.3f} frames/s (host clock, the whole call: load, stage, "
                  f"fuse, render, save) on {smi}; launches {launches}", flush=True)
            check_launches("CLI replay", launches, k4=0)
        else:
            with K.plain_versions():
                run()
        with np.load(CLI / f"{name}_grid.npz") as z:
            grids[name] = torch.from_numpy(z["grid"])
    compare_with_plain("CLI replay", grids["replay"], written_map("replay", "global_map_combined.png"),
                       grids["replay_plain"],
                       written_map("replay_plain", "global_map_combined.png"))
    replay("replay_first", "--input-dir", str(dirs["replay_first"]),
           "--save-grid", str(CLI / "first_half.npz"))
    replay("replay_second", "--input-dir", str(dirs["replay_second"]),
           "--resume-grid", str(CLI / "first_half.npz"), "--save-grid", str(CLI / "both.npz"))
    with np.load(CLI / "both.npz") as z:
        resumed = torch.from_numpy(z["grid"])
    diff = float((resumed - grids["replay"]).abs().max())
    print(f"CLI replay --save-grid then --resume-grid over two halves against one replay of "
          f"both: grid max |diff| {diff}", flush=True)
    if not torch.allclose(resumed, grids["replay"], atol=1e-3):
        raise AssertionError(f"resumed replay differs from one replay by {diff}")


ONLINE_MAPPING = "  DEPTH_METHOD: points_raw\n  BOUNDARY: [[1300, 1500], [480, 680]]\n"


def check_rate_report(what: str, report, launches: dict, fused: bool, smi: str) -> None:
    """A --rate run over the 8-frame bag: every frame fused or dropped, at
    least one fused, drops only of frames, no callback errors, K2 launches
    = frames fused, K4 = frames segmented, K1 1, a finite non-empty grid."""
    dropped = report.dropped_total + report.dropped_frames
    segmented = report.fused_frames if fused else sum(
        n for t, n in report.processed.items() if t.startswith("seg:"))
    print(f"{what} (8 frames at 12 Hz, cameras alternating) on {smi}: published "
          f"{report.published}, fused {report.fused_frames}, dropped {dropped} "
          f"({report.drops or 'no mailbox drops'}, {report.dropped_frames} unsynced), max lag "
          f"{report.max_lag_s * 1e3:.3f} ms, wall {report.wall_duration_s:.3f} s for a "
          f"{report.bag_duration_s:.3f} s bag; launches {launches}", flush=True)
    frame_topics = ("image_raw", "semantic")
    if (report.fused_frames + dropped != WINDOW or report.fused_frames < 1 or report.errors
            or any(not t.endswith(frame_topics) for t in report.drops)):
        raise AssertionError(f"{what}: fused {report.fused_frames}, dropped {dropped}, "
                             f"drops {report.drops}, errors {report.errors}")
    check_launches(what, launches, k4=segmented, k2=report.fused_frames)
    grid = report.grid
    if not bool(torch.isfinite(grid).all()) or float(grid.sum()) <= 0:
        raise AssertionError(f"{what}: grid not finite or empty")


def cli_rate(weights: Path, smi: str, decode_ahead: bool = False) -> None:
    """(d) ``pipeline --rate 1`` over phase 4's feed at 12 Hz, both
    topologies; (e) the same with ``--decode-ahead``."""
    bag = CLI / "online.bag"
    if not bag.exists():
        feed = make_online_feed(seed=200)
        write_bag(bag, [m for i, f in enumerate(feed) for m in frame_messages(
            1.0 + i / 12, f["camera"], f["image"], f["cloud"], "velodyne", *f["pose"])])
    flag = ["--decode-ahead"] if decode_ahead else []
    # each topology twice: the first run's executor threads pay their
    # first use of the card, the second's are comparable
    for what, extra in (("two-node", []), ("two-node, again", []), ("fused node", ["--fused"]),
                        ("fused node, again", ["--fused"])):
        name = ("rate_da_" if decode_ahead else "rate_") + what.replace(", again", "_again") \
            .replace("-", "_").replace(" ", "_")
        cfg = overlay(name, weights, ONLINE_MAPPING, extra="TEST_END_TIME: 1000000000000\n")
        K.reset_launch_counts()
        report = cli_main(["pipeline", "--cfg", cfg, "--bag", str(bag), "--rate", "1.0", *flag,
                           *extra])
        check_rate_report(f"CLI pipeline --rate 1.0 {' '.join(flag)} {what}".replace("  ", " "),
                          report, launches_now(), fused=bool(extra), smi=smi)


def tf_message(stamp: float, T_velo_from_cam1: np.ndarray):
    """/tf: velodyne -> base_link (the engine's tuned extrinsic, inverted)
    and velodyne -> camera1."""
    from scipy.spatial.transform import Rotation

    from vision_semantic_segmentation_tpu_torch.mapping.engine import velodyne_to_baselink

    def edge(child, T):
        return rosbag.TransformStampedMsg(rosbag.Header(0, stamp, "velodyne"), child,
                                          np.float64(T[:3, 3]),
                                          Rotation.from_matrix(T[:3, :3]).as_quat())

    return rosbag.TFMessageMsg([edge("base_link", np.linalg.inv(velodyne_to_baselink())),
                                edge("camera1", T_velo_from_cam1)])


def registered_camera1(msg):
    """The camera1 that MappingNode registers from ``msg`` alone (its own code path)."""
    from vision_semantic_segmentation_tpu_torch.geometry.camera import (
        camera_from_extrinsic, get_camera)
    from vision_semantic_segmentation_tpu_torch.mapping.engine import velodyne_to_baselink
    from vision_semantic_segmentation_tpu_torch.utils.ros_compat import TransformTree

    tree = TransformTree()
    for tr in msg.transforms:
        tree.set_pose(tr.translation, tr.rotation, parent=tr.header.frame_id,
                      child=tr.child_frame_id)
    T_cam_to_velo = np.linalg.inv(velodyne_to_baselink()) @ tree.lookup("base_link", "camera1")
    return camera_from_extrinsic(get_camera("camera1"), T_cam_to_velo)


def decode_ahead_tf(pipeline: FusedFramePipeline, smi: str) -> None:
    """(e) The online bag with camera1's extrinsics on /tf at 0.5 s (the
    built-in calibration) and moved 3 degrees at 1.3 s, 0.3 s after
    camera1's first frame (1.0 s) and inside the decode-ahead window:
    ``run_online(fused=True, decode_ahead=True)`` registers the extrinsics
    in force at 1.0 s."""
    from scipy.spatial.transform import Rotation

    from vision_semantic_segmentation_tpu_torch.geometry.camera import camera_setup_1
    from vision_semantic_segmentation_tpu_torch.runtime.async_bus import run_online

    T_a = np.linalg.inv(camera_setup_1().T)  # camera1 -> velodyne
    T_b = T_a.copy()
    T_b[:3, :3] = Rotation.from_euler("z", 3, degrees=True).as_matrix() @ T_a[:3, :3]
    tf_a, tf_b = tf_message(0.5, T_a), tf_message(1.3, T_b)
    records = [("/tf", tf_a, 0.5)]
    for i, f in enumerate(make_online_feed(seed=200)):
        stamp = 1.0 + i / 12
        if stamp > 1.3 >= records[-1][2]:
            records.append(("/tf", tf_b, 1.3))
        records += [(t, m, stamp) for t, m in frame_messages(
            stamp, f["camera"], f["image"], f["cloud"], "velodyne", *f["pose"])]
    bag = CLI / "online_moved_tf.bag"
    rosbag.write_bag(str(bag), records)
    cfg = online_cfg()
    cfg.OUTPUT_DIR = str(CLI / "out" / "moved_tf")
    fused = FusedFramePipeline(cfg, state_dict=pipeline.model.state_dict(),
                               compute_dtype=torch.bfloat16, distortion="points", device="cuda")
    K.reset_launch_counts()
    report = run_online(cfg, str(bag), rate=1.0, fused=True, pipeline=fused, decode_ahead=True)
    what = "run_online --decode-ahead, fused, camera1 moved on /tf at 1.3 s"
    check_rate_report(what, report, launches_now(), fused=True, smi=smi)
    got = fused.engine.cameras["camera1"]
    want, later = registered_camera1(tf_a), registered_camera1(tf_b)
    err_a = float(np.abs(got.R - want.R).max())
    err_b = float(np.abs(got.R - later.R).max())
    print(f"  {what}: registered camera1 R against the 0.5 s transform max |diff| {err_a:.3e}, "
          f"against the 1.3 s one {err_b:.3e}", flush=True)
    if err_a > 1e-9 or err_b < 1e-3:
        raise AssertionError(f"{what}: camera1 took the wrong extrinsics ({err_a}, {err_b})")


def cli_phase(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """The command line at full width, in this process, over recordings of
    the main path's window and of the online feed."""
    shutil.rmtree(CLI, ignore_errors=True)
    CLI.mkdir(parents=True)
    weights = CLI / "weights.pth"
    torch.save(pipeline.model.state_dict(), weights)
    host = {k: v.cpu().numpy() for k, v in frames.items()}
    records = [FrameRecord(pcd=host["pcd"][i], pcd_frame_id="world",
                           semantic_image=host["image"][i], position=host["position"][i],
                           quaternion=host["quaternion"][i], stamp=1.0 + i / 12)
               for i in range(WINDOW)]
    t0 = time.perf_counter()
    write_bag(CLI / "main_window.bag", [m for f in records for m in frame_messages(
        f.stamp, f.camera, f.semantic_image, f.pcd, "world", f.position, f.quaternion)])
    save_frames(records, str(CLI / "main_window.npz"))
    print(f"CLI recordings written ({time.perf_counter() - t0:.1f} s)", flush=True)
    cli_fused(pipeline, host, weights, smi)
    cli_export(records)
    cli_replay(pipeline, records, weights, smi)
    cli_rate(weights, smi)
    cli_rate(weights, smi, decode_ahead=True)
    decode_ahead_tf(pipeline, smi)


def cli_host_steps(pipeline: FusedFramePipeline, smi: str) -> None:
    """The steps of ``pipeline --fused`` over the .bag one at a time, host
    clock with the card synchronised after each: decode, staging, the fused
    window, render and copy back, the PNG."""
    from vision_semantic_segmentation_tpu_torch.runtime.bag_adapter import stream_bag_frames
    from vision_semantic_segmentation_tpu_torch.runtime.replay import write_png

    replay = MappingReplay(pipeline.cfg, engine=pipeline.engine)
    steps = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = (time.perf_counter() - t0) * 1e3
        return out

    frames = timed("decode", lambda: list(stream_bag_frames(str(CLI / "main_window.bag"))))
    staged = timed("stage", lambda: replay._stage(frames, min_len=1).wait())
    grid = timed("fuse", lambda: pipeline.run_window(pipeline.init_grid(), staged))
    color_map = timed("render and copy", lambda: render.unpack_rgba_image(
        render.render_bev_map_fused(grid, LABEL_COLORS)).cpu().numpy())
    timed("PNG", lambda: write_png(str(CLI / "steps.png"), color_map))
    print(f"CLI fused path step by step on {smi}, host clock, ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
          + f"; total {sum(steps.values()):.2f} for {len(frames)} frames", flush=True)


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



# -- phase 8: host-side commands at full width --------------------------------------
HOST = REPO / "build" / "chip_smoke_host"
PROFILE = dict(window=WINDOW, n_windows=2, repeats=2)


def host_profile(pipeline: FusedFramePipeline, smi: str) -> None:
    """(a) ``profile_stages`` with phase 3's calibrated weights, then the
    ``profile`` command once on random weights."""
    from vision_semantic_segmentation_tpu_torch.runtime.profiling import (
        format_report,
        profile_stages,
    )

    cfg = pipeline.cfg.clone()
    cfg.OUTPUT_DIR = str(HOST / "out")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    result = profile_stages(cfg, state_dict=pipeline.model.state_dict(), image_hw=IMAGE_HW,
                            distortion="auto", log=print, device="cuda", **PROFILE)
    launches = launches_now()
    # each stage runs its first window untimed, then every window per repeat
    frames = PROFILE["window"] * (1 + PROFILE["repeats"] * PROFILE["n_windows"])
    print(f"profile_stages (calibrated weights) on {smi}: null {result['null_ms']} ms, "
          f"forward {result['forward_ms']} ms (raw {result['forward_ms_raw']}), fusion "
          f"{result['fusion_ms']} ms, e2e {result['e2e_ms']} ms (raw {result['e2e_ms_raw']}), "
          f"{result['e2e_fps']} frames/s, warm-up {result['warmup_s']} s; launches {launches}",
          flush=True)
    print(f"  {format_report(result)}", flush=True)
    check_launches("profile_stages", launches, k4=2 * frames, k2=frames, k1=0)
    if result["distortion"] != "points" or result["device_kind"] != torch.cuda.get_device_name():
        raise AssertionError(f"profile_stages: {result['distortion']} on {result['device_kind']}")
    if not all(result[k] > 0 for k in ("null_ms", "forward_ms", "e2e_ms_raw", "e2e_fps")):
        raise AssertionError(f"profile_stages: a stage did not measure: {result}")

    out = HOST / "profile.json"
    cli = cli_main(["profile", "--window", str(WINDOW), "--windows", "1", "--repeats", "1",
                    "--json", str(out)])
    if json.loads(out.read_text()) != cli or cli["image_hw"] != list(IMAGE_HW):
        raise AssertionError("profile --json wrote another dict than it returned")
    print(f"CLI profile (random weights) on {smi}: {cli['e2e_fps']} frames/s, forward "
          f"{cli['forward_ms']} ms, fusion {cli['fusion_ms']} ms", flush=True)


def read_video(path: Path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0,), np.uint8)


def host_video(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """(b) ``video`` over phase 3's 8 frames as a 1440x1920 MJPG, with a demo
    YAML naming phase 5's weights: K4 once a frame, frames equal to the plain
    run's."""
    import cv2

    host = frames["image"].cpu().numpy()
    src = HOST / "drive.avi"
    writer = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                             (IMAGE_HW[1], IMAGE_HW[0]))
    t0 = time.perf_counter()
    for image in host:
        writer.write(np.ascontiguousarray(image[..., ::-1]))
    writer.release()
    encode_ms = (time.perf_counter() - t0) / len(host) * 1e3
    t0 = time.perf_counter()
    decoded = read_video(src)
    decode_ms = (time.perf_counter() - t0) / len(host) * 1e3
    print(f"cv2 MJPG at {IMAGE_HW[0]}x{IMAGE_HW[1]} (host): encode {encode_ms:.2f} ms, "
          f"decode {decode_ms:.2f} ms a frame", flush=True)
    if decoded.shape != (WINDOW, *IMAGE_HW, 3):
        raise AssertionError(f"the MJPG written reads back as {decoded.shape}")

    outs = {}
    for name in ("video", "video_plain"):
        cfg = pipeline.cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.clone()
        cfg.MODEL.WEIGHT = str(CLI / "weights.pth")
        cfg.OUTPUT_DIR = str(HOST)
        cfg.OUTPUT_NAME = name
        yaml = HOST / f"{name}.yaml"
        yaml.write_text(cfg.dump())
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "video":
            out = cli_main(["video", "--cfg", str(yaml), "--video", str(src)])
            launches = launches_now()
            print(f"CLI video: {WINDOW} frames in {time.perf_counter() - t0:.3f} s (host clock, "
                  f"decode to written .avi) on {smi}; launches {launches}", flush=True)
            check_launches("CLI video", launches, k4=WINDOW, k2=0, k1=0)
        else:
            with K.plain_versions():
                out = cli_main(["video", "--cfg", str(yaml), "--video", str(src)])
        outs[name] = read_video(Path(out))
    if outs["video"].shape != (WINDOW, *IMAGE_HW, 3):
        raise AssertionError(f"CLI video wrote {outs['video'].shape}")
    if not np.array_equal(outs["video"], outs["video_plain"]):
        raise AssertionError("CLI video: the frames differ from the plain run's")
    print(f"CLI video: {WINDOW} frames at {IMAGE_HW[0]}x{IMAGE_HW[1]}, decoded frames equal to "
          "the plain run's", flush=True)


def host_convert(pipeline: FusedFramePipeline, frames: dict) -> None:
    """(c) ``convert`` of phase 5's ``weights.pth``: a predictor loaded from the
    ``.npz`` segments a frame as one loaded from the ``.pth``."""
    npz = cli_main(["convert", str(CLI / "weights.pth")])
    labels = {}
    for path in (CLI / "weights.pth", Path(npz)):
        cfg = pipeline.cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.clone()
        cfg.MODEL.WEIGHT = str(path)
        labels[path.suffix] = SemanticSegmentation(cfg, device="cuda").labels(frames["image"][0])
    same = bool(torch.equal(labels[".pth"], labels[".npz"]))
    print(f"CLI convert: {npz} ({Path(npz).stat().st_size} bytes); labels from the .npz equal "
          f"the .pth's: {same} ({len(torch.unique(labels['.npz']))} classes)", flush=True)
    if not same:
        raise AssertionError("convert: the .npz predictor's labels differ from the .pth's")


def host_renderers(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """(d) The off-path renderers and ``stitch_image`` on phase 3's grid (as
    (H, W, C)) on the card, each against the same function on a CPU copy."""
    from vision_semantic_segmentation_tpu_torch.mapping import renderer as R
    from vision_semantic_segmentation_tpu_torch.mapping.stitching import stitch_image

    grid = pipeline.run_window(pipeline.init_grid(), frames).permute(1, 2, 0).contiguous()
    color_map = R.render_bev_map(grid, LABEL_COLORS)
    gray3 = color_map[..., :1].expand(-1, -1, 3).contiguous()
    # three crops of 0.6 of the grid (1200x1200 of 2000x2000); frame i reaches
    # frame i+1 by a shift, half a pixel off in x for the first, so the
    # bilinear warp interpolates
    h, w = grid.shape[:2]
    size = int(0.6 * min(h, w))
    corners = [(0, 0), (3 * h // 20, w // 10), (3 * h // 10, w // 5)]
    crops = [grid[r:r + size, c:c + size] for r, c in corners]
    shifts = [np.array([[1.0, 0.0, c0 - c1 + (0.5 if i == 0 else 0.0)], [0.0, 1.0, r0 - r1],
                        [0.0, 0.0, 1.0]])
              for i, ((r0, c0), (r1, c1)) in enumerate(zip(corners, corners[1:]))]
    shifts.append(np.eye(3))
    cases = {
        "render_bev_map_with_thresholds": (
            lambda g: R.render_bev_map_with_thresholds(g, LABEL_COLORS), (grid,)),
        "render_bev_map_with_thresholds (priority)": (
            lambda g: R.render_bev_map_with_thresholds(
                g, LABEL_COLORS, priority=[3, 4, 0, 2, 1], thresholds=[0.1, 0.1, 0.5, 0.2, 0.05]),
            (grid,)),
        "fill_black": (R.fill_black, (color_map,)),
        "fill_black_mode": (R.fill_black_mode, (color_map,)),
        "resume_color": (R.resume_color, (gray3,)),
        "fill_edge": (R.fill_edge, (color_map,)),
        "log_odds_to_probability": (R.log_odds_to_probability, (grid,)),
        "map_layer_images": (R.map_layer_images, (grid,)),
        "map_layer_images (min-max)": (lambda g: R.map_layer_images(g, normalize=False), (grid,)),
        "stitch_image (log-odds)": (lambda *c: stitch_image(list(c), shifts), crops),
        "stitch_image (painter)": (lambda *c: stitch_image(list(c), shifts, log_odds_out=False),
                                   crops),
    }
    times = {}
    for name, (fn, args) in cases.items():
        got = fn(*args)
        want = fn(*[a.cpu() for a in args])
        got = got.cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} on the card, "
                                 f"{tuple(want.shape)} {want.dtype} on the CPU")
        if got.dtype == torch.uint8:
            ok, err = torch.equal(got, want), int((got != want).sum())
        else:
            err = float((got - want).abs().max())
            ok = err <= 1e-6
        if not ok:
            raise AssertionError(f"{name}: the card's result differs from the CPU's ({err})")
        if not bool((got.float() != 0).any()):
            raise AssertionError(f"{name}: an empty result")
        times[name] = cuda_ms(lambda: fn(*args), 5)
    t0 = time.perf_counter()
    car = R.add_car_to_map(color_map.cpu().numpy(), np.array([120.0, 100.0]), 0.4, 0.1,
                           pipeline.cfg.MAPPING.BOUNDARY)
    car_ms = (time.perf_counter() - t0) * 1e3
    if not (car == [255, 0, 0]).all(-1).any():
        raise AssertionError("add_car_to_map painted nothing")
    print(f"off-path renderers on the card, equal to the CPU (uint8 exactly, floats within "
          f"1e-6), on {tuple(grid.shape)} and 3 crops of {size}x{size}, {smi}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f"; add_car_to_map (host) {car_ms:.3f} ms", flush=True)


def host_phase(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """Phase 8: ``profile``, ``video`` and ``convert``, and the off-path
    renderers, at the main path's width."""
    if not has_module("cv2"):
        raise RuntimeError("phase 8 needs OpenCV (cv2) for the video command")
    shutil.rmtree(HOST, ignore_errors=True)
    HOST.mkdir(parents=True)
    t0 = time.perf_counter()
    host_profile(pipeline, smi)
    host_video(pipeline, frames, smi)
    host_convert(pipeline, frames)
    host_renderers(pipeline, frames, smi)
    print(f"phase 8 (host-side commands) {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 7: training ------------------------------------------------------------
TRAIN = REPO / "build" / "chip_smoke_train"
TRAIN_BATCH = 16
# example_train.yaml names its transforms without the arguments their
# constructors need (the JAX package's build_transform raises on it too):
# the same chains with the 513x513 crop and the ImageNet statistics
NORM_MEAN, NORM_STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
TRAIN_AUG = (f"[RandomHorizontalFlip, [RandomSizeAndCrop, 513, [0.5, 2.0], 255], ToTensor, "
             f"[Normalize, {NORM_MEAN}, {NORM_STD}]]")
VAL_AUG = f"[[FixScaleCenterCrop, 513], ToTensor, [Normalize, {NORM_MEAN}, {NORM_STD}]]"
# 7(c): the served bf16 network's logits against the trained f32 network's,
# as a share of the largest f32 logit.  bf16 keeps 8 significant bits (2^-8
# per rounding); the network rounds its activations once per block, 16
# bottleneck blocks deep, and the errors add: 16 x 2^-8 = 2^-4.  Weights or
# an input that did not cross would differ by the logits' own size.
SERVE_TOL = 2.0 ** -4
GRAD_CASES = [  # name, (frames, H, W, C), dilations
    ("OS16 ASPP", (TRAIN_BATCH, 33, 33, 2048), (6, 12, 18)),
    ("OS8 ASPP", (4, 65, 65, 2048), (12, 24, 36)),
    ("single-branch K3", (4, 33, 33, 2048), (12,)),
]


def plain_branches(x, w9s, dils):
    """Autograd of the plain twins, frame by frame as the wrappers run them."""
    c = x.shape[-1]
    outs = [[] for _ in dils]
    with K.plain_versions():
        for i in range(x.shape[0]):
            kernels = [w9s[b].reshape(3, 3, 1, c) for b in range(len(dils))]
            frame = x[i:i + 1]
            ys = ([depthwise.depthwise3x3_dilated(frame, kernels[0], dils[0])] if len(dils) == 1
                  else depthwise.aspp_depthwise3x3_multi(frame, kernels, dils))
            for b, y in enumerate(ys):
                outs[b].append(y)
    return [torch.cat(o) for o in outs]


def grad_checks(smi: str) -> None:
    """(a) DepthwiseBranches against autograd of the plain twin.

    Tolerances, as a share of the largest reference value: dx 1e-5 in f32
    (the same products summed in another order), 2**-7 in bf16 (the kernel
    route rounds each branch's dx to bf16 before the f32 sum over branches,
    autograd of the twin rounds once); dW 1e-4 (f32 sums over up to 17424
    pixels a tap, in another order).
    """
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, shape, dils in GRAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w9s = torch.randn((len(dils), 9, shape[-1]), generator=gen, device="cuda")
            dys = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in dils]
            results = []
            for run in ("kernels", "plain"):
                xg, wg = x.clone().requires_grad_(True), w9s.clone().requires_grad_(True)
                ys = (depthwise.DepthwiseBranches.apply(xg, wg, dils) if run == "kernels"
                      else plain_branches(xg, wg, dils))
                torch.autograd.backward(list(ys), dys)
                results.append(([y.detach() for y in ys], xg.grad, wg.grad))
            (ys, dx, dw), (ys_p, dx_p, dw_p) = results
            y_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(ys, ys_p))
            dx_err = float((dx.float() - dx_p.float()).abs().max())
            dw_err = float((dw - dw_p).abs().max())
            dx_tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * float(dx_p.float().abs().max())
            dw_tol = 1e-4 * float(dw_p.abs().max())
            print(f"grad {name} {tuple(shape)} d={dils} {str(dtype)[6:]}: forward max|err| {y_err}, "
                  f"dx max|err| {dx_err:.3e} (tolerance {dx_tol:.3e}), dW max|err| {dw_err:.3e} "
                  f"(tolerance {dw_tol:.3e})", flush=True)
            if y_err != 0 or not dx_err <= dx_tol or not dw_err <= dw_tol:
                raise AssertionError(f"DepthwiseBranches {name} {dtype}: gradient differs from the "
                                     "plain twin's")
    # the backward's two halves at the OS16 training shape, bf16
    _, shape, dils = GRAD_CASES[0]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w9s = torch.randn((len(dils), 9, shape[-1]), generator=gen, device="cuda")
    dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    flipped = w9s.flip(1).contiguous()
    dgrad = cuda_ms(lambda: [depthwise._k3(dy[i:i + 1], flipped[b], d)
                             for i in range(shape[0]) for b, d in enumerate(dils)], 10)
    wgrad = cuda_ms(lambda: [depthwise.depthwise_wgrad_plain(x, dy, d) for d in dils], 10)
    forward = cuda_ms(lambda: [depthwise._k4(x[i:i + 1], w9s, dils) for i in range(shape[0])], 10)
    print(f"ASPP depthwise at {tuple(shape)} d={dils} bf16, per train step on {smi}: forward "
          f"(K4 x {shape[0]}) {forward:.3f} ms, dgrad (K3 x {shape[0] * len(dils)}) {dgrad:.3f} ms, "
          f"plain f32 wgrad (x {len(dils)}) {wgrad:.3f} ms", flush=True)


def write_mapillary(root: Path, n_train: int = 32, n_val: int = 4) -> None:
    """A Mapillary-layout dataset of rendered scene frames: 19-class labels
    (the network ids), images PNG data under .jpg names, as 1440x1920."""
    from concurrent.futures import ThreadPoolExecutor

    poses = scene.make_poses()
    picks = np.linspace(0, len(poses) - 1, n_train + n_val).round().astype(int)
    labels = [{"name": str(i), "readable": str(i), "color": c.tolist()}
              for i, c in enumerate(MAPILLARY_19_PALETTE)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps({"labels": labels}))

    def one(k: int) -> None:
        split = "training" if k < n_train else "validation"
        img, lab = scene.render_frame(*poses[picks[k]])
        image_io.write_png(str(root / split / "images" / f"{k:04d}.jpg"), img, level=1)
        image_io.write_png(str(root / split / "labels" / f"{k:04d}.png"), lab.astype(np.uint8),
                           level=1)

    for split in ("training", "validation"):
        for sub in ("images", "labels"):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, range(n_train + n_val)))


def train_run(what: str, out: Path, epochs: int, smi: str, extra=(), steps_before: int = 0):
    """One ``train`` command at full width; checks and prints the run."""
    args = ["train", "--cfg", str(REPO / "configs" / "example_train.yaml"),
            "DATASET.ROOT_DIR", str(TRAIN / "data"), "OUTPUT_DIR", str(out),
            "SCHEDULER.MAX_EPOCH", str(epochs), "DATALOADER.NUM_WORKERS", "8",
            "TRAIN.AUGMENTATION", TRAIN_AUG, "VALIDATE.AUGMENTATION", VAL_AUG, *extra,
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = cli_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    hist = trainer.history
    steps = len(hist)
    val_frames = sum(1 for _ in (TRAIN / "data" / "validation" / "images").iterdir())
    epochs_run = epochs - steps_before // 2
    want = {k.name: 0 for k in K.kernels()}
    want.update({"aspp_depthwise3x3_multi": TRAIN_BATCH * steps + val_frames * epochs_run,
                 "depthwise3x3_dilated": 3 * TRAIN_BATCH * steps})
    losses = [h["loss"] for h in hist]
    batch_t = np.median([h["batch_time"] for h in hist])
    data_t = np.median([h["data_time"] for h in hist])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train {what}: {steps} steps (steps {hist[0]['step']}-{hist[-1]['step']}) in "
          f"{wall:.1f} s command time on {smi}; median step {batch_t * 1e3:.1f} ms = "
          f"{1 / batch_t:.3f} steps/s = {TRAIN_BATCH / batch_t:.2f} images/s (host clock between "
          f"steps), median host wait for data {data_t * 1e3:.1f} ms a step; peak memory "
          f"allocated {peak:.2f} GiB; launches {launches} ({launches['aspp_depthwise3x3_multi']} "
          f"K4 = {TRAIN_BATCH} x {steps} steps + {val_frames} x {epochs_run} validation frames, "
          f"{launches['depthwise3x3_dilated']} K3 = 48 x {steps}); best val mIoU "
          f"{trainer.best_metric:.4f}", flush=True)
    print(f"  loss per step: {[round(v, 4) for v in losses]}", flush=True)
    if launches != want:
        raise AssertionError(f"train {what}: launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {what}: loss not finite")
    return trainer


def train_phase(smi: str) -> Path:
    """(b) full-width training through the command line; returns the f32
    run's checkpoint named by its pointer."""
    t0 = time.perf_counter()
    write_mapillary(TRAIN / "data")
    print(f"train data: 32 + 4 rendered 1440x1920 frames written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    f32 = train_run("f32", TRAIN / "f32", 4, smi)
    losses = [h["loss"] for h in f32.history]
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"train f32: the loss did not fall: {losses}")
    # one more step, inputs on the card, under the profiler
    image = torch.randn((TRAIN_BATCH, 513, 513, 3), device="cuda")
    label = torch.randint(0, 19, (TRAIN_BATCH, 513, 513), device="cuda")
    where_time_goes("one f32 train step, batch 16 at 513x513 (inputs on the card)",
                    lambda: f32._train_step(f32.state, {"image": image, "label": label}))
    bf16 = train_run("bf16", TRAIN / "bf16", 4, smi, extra=("TRAIN.COMPUTE_DTYPE", "bfloat16"))
    losses = [h["loss"] for h in bf16.history]
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"train bf16: the loss did not fall: {losses}")
    where_time_goes("one bf16 train step, batch 16 at 513x513 (inputs on the card)",
                    lambda: bf16._train_step(bf16.state, {"image": image, "label": label}))
    del f32, bf16, image, label
    torch.cuda.empty_cache()
    pointer = (TRAIN / "f32" / "last_checkpoint").read_text().strip()
    saved = torch.load(TRAIN / "f32" / pointer, map_location="cpu", weights_only=False)["step"]
    resumed = train_run("f32 resumed (AUTO_RESUME)", TRAIN / "f32", 5, smi, steps_before=saved)
    steps = [h["step"] for h in resumed.history]
    print(f"  resumed from {pointer} at step {saved}: steps {steps}", flush=True)
    if steps != [saved + 1, saved + 2]:
        raise AssertionError(f"resume from {pointer} (step {saved}) ran steps {steps}")
    del resumed
    torch.cuda.empty_cache()
    return TRAIN / "f32" / (TRAIN / "f32" / "last_checkpoint").read_text().strip()


def serve_trained(weights: Path, smi: str) -> None:
    """(c) the trained checkpoint through MODEL.WEIGHT into the fused
    pipeline, its network configured as example_train.yaml trained it (the
    serving defaults' decoder is wider), held against the train command's
    own network: the served bf16 weights equal the checkpoint's, the
    pipeline's input equals the training chain's ToTensor and Normalize on
    the same scaled frame, and the served logits equal the trained f32
    network's, in eval(), on that input within SERVE_TOL."""
    trained = get_train_cfg_defaults()
    trained.merge_from_file(str(REPO / "configs" / "example_train.yaml"))
    cfg = get_cfg_defaults()
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    for key in ("BACKBONE", "OUTPUT_STRIDE", "ASPP", "DECODER"):
        net.MODEL[key] = trained.MODEL[key]
    net.DATASET.NUM_CLASSES = trained.DATASET.NUM_CLASSES
    net.MODEL.WEIGHT = str(weights)
    pipeline = FusedFramePipeline(cfg, load_weights(net.MODEL.WEIGHT), device="cuda")
    img, lab = scene.render_frame(*scene.make_poses()[5])
    frame = torch.from_numpy(img).cuda()
    seen = {}
    hook = pipeline.model.register_forward_pre_hook(lambda m, a: seen.setdefault("x", a[0]))
    K.reset_launch_counts()
    logits = pipeline.segment(frame)
    launches = launches_now()
    hook.remove()

    # the train command's network, from the checkpoint its trainer saved
    state = torch.load(weights, map_location="cuda", weights_only=False)["model"]
    model = build_train_model(trained, device="cuda")[0]
    model.load_state_dict(state, strict=True)
    model.eval()
    served = pipeline.model.state_dict()
    weights_equal = all(torch.equal(served[k], v.to(served[k].dtype)) for k, v in state.items())
    h, w = img.shape[:2]
    s = pipeline.image_scale
    small = resize_area(frame, (int(h * s), int(w * s))) if s < 1.0 else frame
    chain = Compose([ToTensor(), Normalize(NORM_MEAN, NORM_STD)])
    x_train = chain({"image": small.cpu().numpy(), "label": np.zeros(small.shape[:2])})["image"]
    x_train = torch.from_numpy(x_train).cuda().permute(2, 0, 1)[None]
    x = seen["x"]
    input_err = float((x_train.to(x.dtype).float() - x.float()).abs().max())
    # one bf16 step at the largest value: the card divides by 255 as a
    # product with its reciprocal, numpy divides, and the last f32 bit can
    # round the bf16 result the other way
    input_tol = 2.0 ** -7 * float(x.float().abs().max())
    with torch.no_grad():
        ref = model(x.float(), upsample_pred=pipeline.upsample_pred)
    logit_err = float((logits.float() - ref).abs().max())
    logit_tol = SERVE_TOL * float(ref.abs().max())
    pred, ref_pred = logits.argmax(1)[0], ref.argmax(1)[0]
    agree = float((pred == ref_pred).float().mean())
    truth = scene.subsample_labels(lab, tuple(pred.shape))
    acc = float((pred.cpu().numpy() == truth).mean())
    ref_acc = float((ref_pred.cpu().numpy() == truth).mean())

    def top(a):
        ids, counts = np.unique(a, return_counts=True)
        return {int(i): round(c / a.size, 4) for c, i in sorted(zip(counts, ids), reverse=True)[:3]}

    print(f"serving the trained weights ({weights.name}) on {smi}: logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite {bool(torch.isfinite(logits).all())}, K4 launches "
          f"{launches['aspp_depthwise3x3_multi']}; served weights equal the checkpoint's (as "
          f"{x.dtype}) {weights_equal}; input {tuple(x.shape)} against the training chain's "
          f"ToTensor+Normalize max|err| {input_err} (tolerance {input_tol:.4f}); logits against the trained f32 "
          f"network in eval() max|err| {logit_err:.4f} (tolerance {logit_tol:.4f} = 2^-4 of its "
          f"largest logit), argmax agreement {agree:.4f}", flush=True)
    print(f"  pixel accuracy against the frame's labels: served {acc:.4f}, trained f32 network "
          f"{ref_acc:.4f}; predicted classes (share) {top(pred.cpu().numpy())}, the frame's "
          f"classes {top(truth)}", flush=True)
    if not (bool(torch.isfinite(logits).all()) and launches["aspp_depthwise3x3_multi"] == 1
            and weights_equal and input_err <= input_tol and logit_err <= logit_tol):
        raise AssertionError("serving the trained weights failed")


def golden_phase(smi: str):
    """(d) the golden scene trained on the card, mapped and scored.  Returns
    the trained weights and the scene's frames."""
    from concurrent.futures import ThreadPoolExecutor

    root = TRAIN / "golden"
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    poses = scene.make_poses()
    with ThreadPoolExecutor(8) as pool:
        rendered = list(pool.map(lambda pq: scene.render_frame(*pq), poses))
    images = [r[0] for r in rendered]
    train_idx = list(range(0, len(poses), len(poses) // 8))[:8]
    stride = len(poses) // 8
    val_idx = [min(i + max(1, stride // 2), len(poses) - 1) for i in train_idx]

    def small(idx):
        return ([resize_area(torch.from_numpy(images[i]).cuda(), (144, 192)).cpu().numpy()
                 .astype(np.float32) for i in idx], [rendered[i][1][4::10, 4::10] for i in idx])

    frames, labels = small(train_idx)
    val_frames, val_labels = small(val_idx)
    print(f"golden scene: 90 frames rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    weights = root / "segmenter.pth"
    t0 = time.perf_counter()
    acc = scene.train_segmenter(frames, labels, str(weights), max_steps=300,
                                val_frames=val_frames, val_labels=val_labels, device="cuda",
                                log=lambda m: print(m, flush=True))
    print(f"golden segmenter trained in {time.perf_counter() - t0:.1f} s on {smi}: train-batch "
          f"accuracy {acc:.4f} (evaluation step)", flush=True)
    gt = root / "gt"
    gt.mkdir(exist_ok=True)
    scene.write_truth_arrays(str(gt))
    bag = scene.build_scene_bag(str(root / "golden.npz"), images, poses)
    cfg = scene.apply_scene_mapping_cfg(scene.scene_network_cfg(str(weights)), image_scale=0.1)
    cfg.OUTPUT_DIR = str(root / "out")
    cfg.GROUND_TRUTH_DIR = str(gt)
    (root / "golden.yaml").write_text(cfg.dump())
    K.reset_launch_counts()
    run = cli_main(["pipeline", "--cfg", str(root / "golden.yaml"), "--bag", bag, "--fused"])
    launches = launches_now()
    result = MapEvaluator(ground_truth_dir=str(gt)).test_single_map(run.color_map, verbose=False)
    iou = result["iou"]
    print(f"golden map on the card ({run.frames} frames, {run.frames / run.seconds:.3f} frames/s, "
          f"launches {launches}): IoU road {iou['road']:.4f} (floor 0.88), crosswalk "
          f"{iou['crosswalk']:.4f} (0.92), lane {iou['lane']:.4f} (0.80), mIoU "
          f"{result['miou']:.4f} (0.87); accuracy {result['mean_accuracy']:.4f}, per class "
          f"{ {k: round(v, 4) for k, v in result['accuracy'].items()} }, missing rate "
          f"{result['missing_rate']:.6f}", flush=True)
    if not (iou["road"] >= 0.88 and iou["crosswalk"] >= 0.92 and iou["lane"] >= 0.80
            and result["miou"] >= 0.87):
        raise AssertionError(f"golden map under its floors: {result}")
    return weights, images


def training_phase(smi: str):
    """Phase 7: (a) gradients, (b) training, (c) serving, (d) the golden
    scene.  Returns the golden segmenter's weights and the scene's frames."""
    if TRAIN.exists():
        shutil.rmtree(TRAIN)
    # the golden trainer seeds its own dropout: draw from the global CUDA
    # generator what no earlier phase draws, and the golden floors must hold
    torch.cuda.manual_seed(12345)
    torch.nn.functional.dropout(torch.ones(1 << 26, device="cuda"), 0.5)
    print("phase 7: the global CUDA generator seeded 12345 and drawn for 2**26 dropout "
          "elements before training", flush=True)
    t0 = time.perf_counter()
    grad_checks(smi)
    weights = train_phase(smi)
    serve_trained(weights, smi)
    golden = golden_phase(smi)
    print(f"phase 7 (training) {time.perf_counter() - t0:.1f} s", flush=True)
    return golden


# -- phase 9: int8 serving ------------------------------------------------------------
INT8 = REPO / "build" / "chip_smoke_int8"
INT8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 on the tensor cores
# the 3x3 sites of the int8 ResNeXt50-32x4d OS8 at 1440x1920, one a block:
# (H, W, C) of the input, stride, dilation, sites a frame
Q1_SITES = [
    ((360, 480, 128), 1, 1, 3),   # layer1
    ((360, 480, 256), 2, 1, 1),   # layer2_0
    ((180, 240, 256), 1, 1, 3),   # layer2_1-3
    ((180, 240, 512), 1, 1, 1),   # layer3_0
    ((180, 240, 512), 1, 2, 5),   # layer3_1-5
    ((180, 240, 1024), 1, 2, 1),  # layer4_0
    ((180, 240, 1024), 1, 4, 2),  # layer4_1-2
]
# a BasicBlock's (resnet18 OS8 at 1440x1920, layer2_0): its strided conv1
# and its conv2; (H, W, Cin), Cout, stride, dilation, output kinds
Q1_BASIC = [
    ((360, 480, 64), 128, 2, 1, [(torch.int8, True), (torch.int8, False)]),
    ((180, 240, 128), 128, 1, 1, [(torch.bfloat16, False), (torch.float32, True)]),
]
Q1_KINDS = [(torch.int8, True), (torch.bfloat16, False)]  # a ResNeXt site, then a float out
# shapes off the frame's sites, each in every output kind: the inner 4-band
# halo-extended inputs of phase 13(c) at layer1 and layer4, and a shape
# that Q1's output tile divides in neither axis; (H, W, C), stride, dilation
Q1_EDGES = [
    ((92, 480, 128), 1, 1),
    ((53, 240, 1024), 1, 4),
    ((45, 61, 512), 1, 2),
]
Q1_ALL_KINDS = [(torch.int8, True), (torch.bfloat16, False), (torch.float32, True)]


def q1_work(x, w, stride: int, dilation: int, out_itemsize: int):
    """(bytes, int8 operations) of one Q1 call: each input, weight and output
    byte once and the two epilogue vectors; two operations a multiply-add,
    over the taps that land inside the image."""
    n, h, wd, _ = x.shape
    cout, _, _, cg = w.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1  # padding = dilation

    def inside(size, osize):  # (output, tap) pairs inside the image along one axis
        pos = np.arange(osize)[:, None] * stride - dilation + np.arange(3)[None] * dilation
        return int(((pos >= 0) & (pos < size)).sum())

    ops = 2 * n * cout * cg * inside(h, ho) * inside(wd, wo)
    return x.numel() + w.numel() + n * ho * wo * cout * out_itemsize + 8 * cout, ops


def q1_site(gen, hwc, cout: int, stride: int, dilation: int, groups: int, kinds) -> dict:
    """Q1 against its plain version at one site shape, for each output kind
    (the first one timed), with the bf16 cuDNN conv of the same site."""
    from vision_semantic_segmentation_tpu_torch.ops.kernels import int8_conv

    h, w, c = hwc
    cg = c // groups
    x = torch.randint(0, 128, (1, h, w, c), generator=gen, device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, 3, 3, cg), generator=gen, device="cuda",
                       dtype=torch.int8)
    spread = 3.0 * (9 * cg) ** 0.5 * 73.3 * 73.3  # three standard deviations of a sum
    jitter = torch.rand(cout, generator=gen, device="cuda") + 0.5
    scales = {torch.int8: (127.0 / spread * jitter, torch.rand(cout, generator=gen, device="cuda") * 40 - 20),
              "float": (4.0 / spread * jitter, torch.rand(cout, generator=gen, device="cuda") * 2 - 1)}
    acc = int8_conv.int8_conv3x3_acc_plain(x, wt, stride, dilation, dilation, groups)
    errs = []
    for dtype, relu in kinds:
        scale, shift = scales[torch.int8 if dtype == torch.int8 else "float"]
        got = int8_conv.int8_conv3x3(x, wt, scale, shift, stride, dilation, dilation, groups,
                                     dtype, relu)
        ref = int8_conv.epilogue(acc, scale, shift, dtype, relu)
        torch.cuda.synchronize()
        errs.append(float((got.float() - ref.float()).abs().max()))
    dtype, relu = kinds[0]
    scale, shift = scales[torch.int8 if dtype == torch.int8 else "float"]
    args = (x, wt, scale, shift, stride, dilation, dilation, groups, dtype, relu)

    def q1():
        return int8_conv.int8_conv3x3(*args)

    ms, graph = cuda_ms(q1, 20), graph_ms(q1, 20)
    plain_ms = cuda_ms(lambda: int8_conv.int8_conv3x3_plain(*args), 1)
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    wb = wt.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def cudnn():
        return F.conv2d(xb, wb, None, stride, dilation, dilation, groups)

    cudnn_ms, cudnn_graph = cuda_ms(cudnn, 20), graph_ms(cudnn, 20)
    nbytes, ops = q1_work(x, wt, stride, dilation, torch.empty((), dtype=dtype).element_size())
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
    print(f"  Q1 {tuple(x.shape)} -> {cout}, groups {groups}, stride {stride}, dilation "
          f"{dilation}, {[(str(d).split('.')[-1], r) for d, r in kinds]}: max |err| {errs} vs "
          f"plain; launched one by one {ms:.4f} ms (bf16 cuDNN {cudnn_ms:.4f} ms), in a CUDA "
          f"graph {graph:.4f} ms (bf16 cuDNN {cudnn_graph:.4f} ms), plain {plain_ms:.4f} ms; "
          f"bound {bound_ms * 1e3:.1f} us, {bound_ms / ms:.1%} of it launched one by one, "
          f"{bound_ms / graph:.1%} in a graph", flush=True)
    return dict(err=max(errs), ms=ms, graph_ms=graph, plain_ms=plain_ms, cudnn_ms=cudnn_ms,
                cudnn_graph_ms=cudnn_graph, bytes=nbytes, ops=ops)


def check_int8_conv(smi: str) -> dict:
    """(a) Q1 against its plain version at each 3x3 site shape of the int8
    ResNeXt50 at 1440x1920, at a BasicBlock's two and at ``Q1_EDGES``; the
    kernels line gets a frame's 16 sites summed, launched one by one."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    times = ("ms", "graph_ms", "plain_ms", "cudnn_ms", "cudnn_graph_ms")
    total = dict(err=0.0, bytes=0, ops=0, **dict.fromkeys(times, 0.0))
    print(f"phase 9(a) Q1 on {smi}:", flush=True)
    for hwc, stride, d, count in Q1_SITES:
        r = q1_site(gen, hwc, hwc[2], stride, d, 32, Q1_KINDS)
        total["err"] = max(total["err"], r["err"])
        for k in (*times, "bytes", "ops"):
            total[k] += count * r[k]
    for hwc, cout, stride, d, kinds in Q1_BASIC:
        total["err"] = max(total["err"], q1_site(gen, hwc, cout, stride, d, 1, kinds)["err"])
    for hwc, stride, d in Q1_EDGES:
        total["err"] = max(total["err"],
                           q1_site(gen, hwc, hwc[2], stride, d, 32, Q1_ALL_KINDS)["err"])
    b_bytes, b_ops = total["bytes"] / HBM_BYTES_PER_S * 1e3, total["ops"] / INT8_OPS_PER_S * 1e3
    b_ms, b_by = (b_bytes, "bytes") if b_bytes >= b_ops else (b_ops, "operations")
    print(f"kernel int8_conv3x3 (a frame's 16 sites): max_abs_err {total['err']} kernel "
          f"{total['ms']:.4f} ms launched one by one (bf16 cuDNN grouped convs "
          f"{total['cudnn_ms']:.4f} ms), {total['graph_ms']:.4f} ms in CUDA graphs (bf16 cuDNN "
          f"{total['cudnn_graph_ms']:.4f} ms), plain {total['plain_ms']:.4f} ms, bound "
          f"{b_ms * 1e3:.1f} us ({b_by}; bytes {b_bytes * 1e3:.1f} us, int8 operations "
          f"{b_ops * 1e3:.1f} us), {b_ms / total['ms']:.1%} of the bound launched one by one, "
          f"{b_ms / total['graph_ms']:.1%} in CUDA graphs", flush=True)
    if total["err"] != 0:
        raise AssertionError(f"Q1 differs from its plain version by {total['err']}")
    return {
        "name": "int8_conv3x3", "route": "cuda",
        "source": "vision_semantic_segmentation_tpu_torch/csrc/int8_conv.cu",
        "replaces": "vision_semantic_segmentation_tpu/models/quant.py:385", "launches": 0,
        "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def int8_quantize(weights: Path, smi: str) -> Path:
    """(b) ``quantize`` over phase 5's recorded bag, 8 calibration frames:
    the qpack in the JAX package's format."""
    shutil.rmtree(INT8, ignore_errors=True)
    INT8.mkdir(parents=True)
    out = INT8 / "qpack.npz"
    K.reset_launch_counts()
    t0 = time.perf_counter()
    cli_main(["quantize", "--cfg", overlay("quantize", weights), "--calib",
              str(CLI / "main_window.bag"), "--frames", str(WINDOW), "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = launches_now()
    check_launches("quantize (calibration runs the float backbone alone)", launches, k4=0, k2=0,
                   k1=0)
    with np.load(out) as z:
        arrays = {k: z[k] for k in z.files}
    sites = sorted({k.rsplit("|", 1)[0] for k in arrays})
    bad = []
    for site in sites:
        fields = {f: arrays[f"{site}|{f}"] for f in ("w_q", "w_scale", "bn_scale", "bn_bias",
                                                     "in_scale") if f"{site}|{f}" in arrays}
        emits = site.endswith(("conv1", "conv2"))
        want_w = 5 if site.endswith("conv2") else 4
        if (len(fields) != 5 or fields["w_q"].dtype != np.int8 or fields["w_q"].ndim != want_w
                or any(fields[f].dtype != np.float32 for f in fields if f != "w_q")
                or fields["in_scale"].shape != () or (f"{site}|out_scale" in arrays) != emits):
            bad.append(site)
    tiles = {s.split("_")[0]: arrays[f"{s}|w_q"].shape for s in sites if s.endswith("_0/conv2")}
    print(f"phase 9(b) quantize over the .bag ({WINDOW} calibration frames) on {smi}: "
          f"{seconds:.3f} s, {out.stat().st_size} bytes, {len(sites)} sites, {len(arrays)} "
          f"arrays; grouped kernels (tile-diagonal) {tiles}; launches {launches}", flush=True)
    if len(sites) != 52 or bad:
        raise AssertionError(f"quantize: {len(sites)} sites (52 expected), malformed {bad}")
    return out


def int8_online(pipeline: FusedFramePipeline, qpack: Path, smi: str) -> dict:
    """(c) The two-node dataflow serving the qpack over phase 4's 8 frames,
    against the same run on the plain path; the int8 forward against the
    bf16 one on one frame.  Returns the launch counts."""
    cfg = online_cfg()
    net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    state = pipeline.model.state_dict()
    feed = make_online_feed(seed=200)

    def predictor(qpack_path):
        net_cfg.MODEL.QPACK = str(qpack_path)
        return SemanticSegmentation(net_cfg, state_dict=state, compute_dtype=torch.bfloat16,
                                    device="cuda")

    def two_node(bus):
        SegmentationNode(cfg, bus, predictor=predictor(qpack))
        return MappingNode(cfg, bus, device="cuda")

    what = "phase 9(c) online two-node, int8 (MODEL.QPACK)"
    online_run(what + " warm-up", two_node, feed, smi)
    grid, color_map, launches = online_run(what, two_node, feed, smi)
    check_launches(what, launches, q1=16 * WINDOW)
    with K.plain_versions():
        grid_plain, map_plain, _ = online_run(what + " (plain)", two_node, feed, smi)
    compare_with_plain(what, grid, color_map, grid_plain, map_plain)

    frame = torch.from_numpy(feed[0]["image"]).cuda()
    q, f = predictor(qpack), predictor("")
    int8_ms = cuda_ms(lambda: q.logits(frame), 10)
    bf16_ms = cuda_ms(lambda: f.logits(frame), 10)
    agree = float((q.labels(frame) == f.labels(frame)).float().mean())
    print(f"  int8 forward {int8_ms:.3f} ms against bf16 {bf16_ms:.3f} ms (CUDA events, one "
          f"1440x1920 frame, ResNeXt50 OS8) on {smi}; labels equal to the bf16 float path's on "
          f"{agree:.4f} of the pixels (seeded weights: reported, not held)", flush=True)
    int8_witness(q, f, net_cfg, state, frame, smi)
    where_time_goes("one int8 forward (1440x1920, ResNeXt50 OS8, the frame on the card)",
                    lambda: q.logits(frame), top=10)
    return launches


def int8_witness(q, f, net_cfg, state, frame, smi: str) -> None:
    """Beside the bf16 int8-vs-float label agreement: the same in f32 (the
    network in f32, calibrated in f32 on the same 8 frames of the bag), and
    the float path's own bf16-vs-f32 agreement, with each pair's relative
    RMS of the logits.  A seeded random network's labels move under any
    small change (tests/test_torch_quant_resnext.py reads the same in the
    JAX package); reported, not held."""
    from vision_semantic_segmentation_tpu_torch.runtime.bag_adapter import bag_to_frames

    def compare(a, b):
        a, b = a.float(), b.float()
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        return agree, float(((a - b).square().mean() / b.square().mean()).sqrt())

    t0 = time.perf_counter()
    net_cfg.MODEL.QPACK = ""
    f32 = SemanticSegmentation(net_cfg, state_dict=state, compute_dtype=torch.float32,
                               device="cuda")
    float32 = f32.logits(frame)
    f32.quantize([r.semantic_image for r in bag_to_frames(str(CLI / "main_window.bag"))])
    pairs = {"int8 vs float, bf16": (q.logits(frame), f.logits(frame)),
             "int8 vs float, f32": (f32.logits(frame), float32),
             "float bf16 vs float f32": (f.logits(frame), float32)}
    if not all(bool(torch.isfinite(a).all()) for pair in pairs.values() for a in pair):
        raise AssertionError("int8 witness: logits not finite")
    readings = {k: compare(*v) for k, v in pairs.items()}
    print(f"  witness on {smi} (one 1440x1920 frame; labels equal, relative RMS of the logits): "
          + "; ".join(f"{k} {a:.4f}, {r:.4f}" for k, (a, r) in readings.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def native_decoder(smi: str) -> None:
    """(e) The C++ cloud decoder on phase 5's bag against the numpy decoder."""
    from vision_semantic_segmentation_tpu_torch.runtime import native_io

    if not native_io.native_available():
        raise AssertionError(f"the native PointCloud2 decoder did not build: {native_io._failure}")
    clouds = [m.message for m in rosbag.RosbagReader(str(CLI / "main_window.bag")).read_messages()
              if isinstance(m.message, rosbag.PointCloud2Msg)]

    def numpy_decode(c):
        by = {f.name: f for f in c.fields}
        fields = [by[k] for k in ("x", "y", "z", "intensity")]
        return native_io._numpy_decode(c.data, c.height * c.width, c.point_step,
                                       [f.offset for f in fields], [7] * 4, False)

    times = {"native": [], "numpy": []}
    before = native_io.calls["native"]
    for _ in range(3):
        t0 = time.perf_counter()
        native = [c.xyzi() for c in clouds]
        times["native"].append((time.perf_counter() - t0) / len(clouds) * 1e3)
        t0 = time.perf_counter()
        plain = [numpy_decode(c) for c in clouds]
        times["numpy"].append((time.perf_counter() - t0) / len(clouds) * 1e3)
    used = native_io.calls["native"] - before
    equal = all(np.array_equal(a, b) for a, b in zip(native, plain))
    print(f"phase 9(e) native PointCloud2 decoder on {smi}'s host: {len(clouds)} clouds of "
          f"{native[0].shape[1]} points, {min(times['native']):.3f} ms a cloud against numpy's "
          f"{min(times['numpy']):.3f} ms (best of 3, host clock); equal {equal}; native decodes "
          f"{used}, in this run so far {native_io.calls}", flush=True)
    if not equal or used != 3 * len(clouds):
        raise AssertionError("the native decoder differs from numpy's or did not run")


def int8_phase(pipeline: FusedFramePipeline, smi: str) -> dict:
    """Phase 9 (a), (b), (c), (e) on phase 3's network and phase 5's
    recordings; returns Q1's kernels-line entry with (c)'s launches."""
    t0 = time.perf_counter()
    q1 = check_int8_conv(smi)
    qpack = int8_quantize(CLI / "weights.pth", smi)
    q1["launches"] = int8_online(pipeline, qpack, smi)["int8_conv3x3"]
    native_decoder(smi)
    print(f"phase 9 (int8 serving, (a)-(c), (e)) {time.perf_counter() - t0:.1f} s", flush=True)
    return q1


def int8_golden(weights: Path, images: list, smi: str) -> None:
    """(d) Phase 7(d)'s trained resnet18 quantized on 3 of its frames at
    144x192: labels equal to the f32 float path's on at least 0.97 of the
    pixels (the floor of the JAX package's tests/test_e2e_golden.py)."""
    t0 = time.perf_counter()
    net = scene.scene_network_cfg(str(weights)).VISION_SEM_SEG.SEM_SEG_NETWORK
    seg = SemanticSegmentation(net, compute_dtype="float32", device="cuda")
    frames = [resize_area(torch.from_numpy(im).cuda(), (144, 192)).cpu().numpy()
              for im in images[::10]]
    refs = [seg.segmentation(f, upsample_pred=True) for f in frames]
    K.reset_launch_counts()
    seg.quantize(frames[:3])
    agree = float(np.mean([(seg.segmentation(f, upsample_pred=True) == r).mean()
                           for f, r in zip(frames, refs)]))
    launches = launches_now()
    print(f"phase 9(d) golden scene, int8 resnet18 OS16 (calibrated on 3 of {len(frames)} "
          f"frames at 144x192) on {smi}: labels equal to the f32 float path's on {agree:.4f} "
          f"of the pixels (floor 0.97); launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if agree < 0.97 or launches["int8_conv3x3"] != 16 * len(frames):
        raise AssertionError(f"golden int8: agreement {agree}, launches {launches}")

# -- phase 10: the serving tools -----------------------------------------------------

SERVING = REPO / "build" / "chip_smoke_serving"
XCEPTION_K3_SITES = 60  # stride-1 separable convs of Xception65 a frame (models/xception.py)


def xception_cfg():
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(SERVING / "xception")
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.TYPE = "Xception"
    net.MODEL.OUTPUT_STRIDE = 16
    return cfg


def calibrate_xception(pipeline: FusedFramePipeline, frame_u8: torch.Tensor) -> dict:
    """BatchNorm statistics from one frame (as ``calibrate_batchnorm``), and
    the (H, W, C) input of every depthwise conv that runs K3, counted."""
    from vision_semantic_segmentation_tpu_torch.models.layers import DepthwiseConv2d

    model = pipeline.model
    sites: dict = {}

    def record(module, inputs):
        _, c, h, w = inputs[0].shape
        sites[(h, w, c)] = sites.get((h, w, c), 0) + 1

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, DepthwiseConv2d) and m.uses_k3()]
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    model.train()
    pipeline.segment(frame_u8)
    model.eval()
    for h in hooks:
        h.remove()
    return sites


def xception_k3_sites(sites: dict, smi: str) -> dict:
    """K3 against its plain version at every distinct Xception site shape
    (f32 and bf16, max |err| 0), each timed in bf16 through its C entry
    point and its wrapper against ``F.conv2d(groups=C)``, the plain version
    and its bound; returns K3's kernels-line entry for a frame's sites."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    total = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0.0, "flops": 0.0}
    for (h, w, c), count in sorted(sites.items()):
        x = torch.randn((1, h, w, c), generator=gen, device="cuda")
        w9 = torch.randn((9, c), generator=gen, device="cuda")
        for xt in (x, x.to(torch.bfloat16)):
            walker_exact("depthwise3x3_dilated", f"Xception site {(h, w, c)}", xt, w9, 1)
        xbf = x.to(torch.bfloat16)
        kernel = w9.reshape(3, 3, 1, c)
        plan = depthwise.depthwise_plan(h, w, c, 1, 2, aligned=depthwise.pointers_aligned(xbf, w9))
        y = torch.empty_like(xbf)
        args = plan.c_args()
        launches = depthwise.KERNEL.launches
        ms = graph_ms(lambda: depthwise.KERNEL.launch(
            depthwise.ptr(xbf), depthwise.ptr(w9), depthwise.ptr(y), h, w, c, 1,
            depthwise._DTYPES[torch.bfloat16],
            depthwise.ctypes.cast(args, depthwise.ctypes.c_void_p)), 30)
        depthwise.KERNEL.launches = launches  # captured launches are no launches
        if not torch.equal(y, depthwise.depthwise3x3_dilated(xbf, kernel, 1)):
            raise AssertionError(f"K3 replayed from a CUDA graph differs at {(h, w, c)}")
        wrapper_ms = cuda_ms(lambda: depthwise.depthwise3x3_dilated(xbf, kernel, 1), 30)
        plain_ms = cuda_ms(lambda: depthwise.depthwise3x3_dilated_plain(xbf, w9, 1), 3)
        lib_ms = cuda_ms(lambda: grouped_conv(xbf, kernel, 1), 20)
        nbytes, flops = 2 * h * w * c * 2 + 9 * c * 4, 18 * h * w * c
        b_ms, _ = bound(nbytes, flops)
        print(f"  K3 Xception site (H, W, C) {(h, w, c)} x{count} a frame: max |err| 0 vs plain "
              f"(f32 and bf16); bf16 kernel {ms:.4f} ms ({b_ms / ms:.1%} of its bound "
              f"{b_ms * 1e3:.1f} us), through the wrapper {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, conv2d {lib_ms:.4f} ms; plan group {plan.group} threads "
              f"{plan.threads} tile {plan.tile_h}x{plan.tile_w} smem {plan.smem} on {smi}",
              flush=True)
        for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms), ("bytes", nbytes),
                       ("flops", flops)):
            total[key] += count * v
    print(f"  K3 over a frame's {sum(sites.values())} Xception sites: kernel "
          f"{total['ms']:.4f} ms, plain {total['plain']:.4f} ms, conv2d {total['lib']:.4f} ms, "
          f"bound {bound(total['bytes'], total['flops'])[0] * 1e3:.1f} us", flush=True)
    return entry(
        "depthwise3x3_dilated", "vision_semantic_segmentation_tpu_torch/csrc/depthwise.cu",
        "vision_semantic_segmentation_tpu/ops/pallas/depthwise.py:224", 0.0,
        total["ms"], total["plain"], total["lib"], total["bytes"], total["flops"],
    )


def xception_phase(smi: str) -> dict:
    """(a) Xception65 at full width through ``FusedFramePipeline``: K3 60 a
    frame; returns K3's kernels-line entry with this window's launches."""
    cfg = xception_cfg()
    t0 = time.perf_counter()
    pipeline = FusedFramePipeline(cfg, compute_dtype=torch.bfloat16, distortion="points",
                                  device="cuda", generator=torch.Generator().manual_seed(7))
    replay = MappingReplay(cfg, engine=pipeline.engine)
    frames = make_window(cfg, seed=900)
    sites = calibrate_xception(pipeline, frames["image"][0])
    n_sites = sum(sites.values())
    print(f"Xception65 set-up {time.perf_counter() - t0:.1f} s; {n_sites} K3 sites a frame at "
          f"{len(sites)} distinct shapes {sorted(sites.items())}", flush=True)
    if n_sites != XCEPTION_K3_SITES:
        raise AssertionError(f"Xception65 has {n_sites} K3 sites a frame, not {XCEPTION_K3_SITES}")
    pipeline.step(pipeline.init_grid(), frames["image"][0], frames["pcd"][0],
                  frames["valid"][0], frames["position"][0], frames["quaternion"][0])
    grid = pipeline.init_grid()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    grid = pipeline.run_window(grid, frames)
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t0
    color_map = replay.finalize(grid, "xception")
    launches = launches_now()
    print(f"Xception65 window launches {launches}", flush=True)
    expected = {k.name: 0 for k in K.kernels()}
    expected.update({"depthwise3x3_dilated": XCEPTION_K3_SITES * WINDOW,
                     "evidence_fold_add": WINDOW, "render_bev_map_fused": 1})
    if launches != expected:
        raise AssertionError(f"Xception65 window: launch counts {launches} != {expected}")
    forward_ms = cuda_ms(lambda: pipeline.segment(frames["image"][1]), 5)
    print(f"Xception65 OS16 bf16 at {IMAGE_HW[0]}x{IMAGE_HW[1]}: {WINDOW / t_window:.3f} "
          f"frames/s, {t_window / WINDOW * 1e3:.2f} ms/frame (host clock, window of {WINDOW}, "
          f"2000x2000 grid), forward {forward_ms:.3f} ms (CUDA events) on {smi}", flush=True)
    args = [frames[k][1] for k in ("image", "pcd", "valid", "position", "quaternion")]
    where_time_goes("one Xception65 frame (inputs on the card)",
                    lambda: pipeline.step(pipeline.init_grid(), *args))
    with K.plain_versions():
        grid_plain = pipeline.run_window(pipeline.init_grid(), frames)
        map_plain = replay.finalize(grid_plain, "xception_plain")
    torch.cuda.synchronize()
    compare_with_plain("Xception65 window", grid, color_map, grid_plain, map_plain)
    del pipeline, grid_plain
    k3 = xception_k3_sites(sites, smi)
    k3["launches"] = launches["depthwise3x3_dilated"]
    return k3


def compile_phase(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """(b) ``compile`` of phase 3's network, loaded with its state dict and
    run over the main path's window."""
    from vision_semantic_segmentation_tpu_torch.runtime.export import load_sequence_runner

    weights = CLI / "weights.pth"
    out = SERVING / "runner.vsstexp"
    t0 = time.perf_counter()
    cli_main(["compile", "--cfg", overlay("compile", weights), "--out", str(out),
              "--window", str(WINDOW)])
    export_s = time.perf_counter() - t0
    state_dict = load_weights(str(weights))
    t0 = time.perf_counter()
    run, meta = load_sequence_runner(str(out), state_dict)
    load_s = time.perf_counter() - t0
    sd_bytes = sum(t.numel() * t.element_size() for t in state_dict.values())
    size = out.stat().st_size
    print(f"compile: export {export_s:.2f} s, load {load_s:.2f} s, artifact {size} bytes "
          f"against the state dict's {sd_bytes}; meta { {k: v for k, v in meta.items() if k != 'parameters'} }",
          flush=True)
    if size >= sd_bytes:
        raise AssertionError("the exported artifact holds the weights")
    run(pipeline.init_grid(), frames)  # first use (cuDNN's algorithm choice)
    grid = pipeline.init_grid()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out_grid = run(grid, frames)
    torch.cuda.synchronize()
    t_loaded = time.perf_counter() - t0
    launches = launches_now()
    check_launches("loaded exported runner", launches, k1=0)
    if out_grid is not grid:
        raise AssertionError("the loaded runner did not update the grid in place")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = pipeline.run_window(pipeline.init_grid(), frames)
    torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    diff = float((grid - direct).abs().max())
    print(f"compile: loaded runner {WINDOW / t_loaded:.3f} frames/s against run_window's "
          f"{WINDOW / t_direct:.3f} (host clock, window of {WINDOW}) on {smi}; launches "
          f"{launches}; grid max |diff| {diff} against run_window's", flush=True)
    if not torch.allclose(grid, direct, atol=1e-3) or float(grid.sum()) <= 0:
        raise AssertionError(f"the exported runner's grid differs from run_window's by {diff}")
    try:
        run(pipeline.init_grid(), {k: v[:WINDOW - 1] for k, v in frames.items()})
    except ValueError as exc:
        print(f"  a window of {WINDOW - 1} refused: {exc}", flush=True)
    else:
        raise AssertionError("the loaded runner took a window of another length")


def autotune_phase(pipeline: FusedFramePipeline, frames: dict, smi: str) -> None:
    """(c) ``autotune`` at full width over a lossy and a safe update window;
    the overlay merged into a config that runs a window; a non-default fold
    and sort name runs K2 and gives that window's grid."""
    cfg = get_cfg_defaults()
    required = int(np.ceil(2.2 * cfg.MAPPING.PCD.RANGE_MAX / cfg.MAPPING.RESOLUTION))
    lossy = required // 2
    tuned = SERVING / "tuned.yaml"
    t0 = time.perf_counter()
    result = cli_main(["autotune", "--cfg", overlay("autotune", CLI / "weights.pth"), "--out",
                       str(tuned), "--window", str(WINDOW), "--windows", "1", "--repeats", "1",
                       "--update-windows", f"{lossy},0"])
    rows = result["rows"]
    print(f"autotune: {len(rows)} rows in {time.perf_counter() - t0:.1f} s on {smi} "
          f"(device_kind {result['device_kind']}); safe window needs {required} cells, "
          f"{lossy} is lossy; best {result['best']}", flush=True)
    for r in rows:
        print(f"  {r}", flush=True)
    if len(rows) != 2 or result["best"]["lossy"] or not any(r["lossy"] for r in rows):
        raise AssertionError(f"autotune rows {rows}, best {result['best']}")
    merged = get_cfg_defaults()
    merged.merge_from_file(str(tuned))
    if int(merged.MAPPING.UPDATE_WINDOW) != result["best"]["update_window"]:
        raise AssertionError(f"the overlay {tuned.read_text()!r} does not name the best row")
    state = pipeline.model.state_dict()
    tuned_grid = FusedFramePipeline(merged, state, distortion="points").run_window(
        pipeline.engine.init_grid(), frames)
    if not bool(torch.isfinite(tuned_grid).all()) or float(tuned_grid.sum()) <= 0:
        raise AssertionError("the tuned config's window gave an empty grid")
    # the overlay names the dense update, so ``merged`` is the default config
    merged.MAPPING.FOLD_METHOD, merged.MAPPING.SORT_METHOD = "scatter", "radix"
    K.reset_launch_counts()
    g = FusedFramePipeline(merged, state, distortion="points").run_window(
        pipeline.engine.init_grid(), frames)
    k2 = launches_now()["evidence_fold_add"]
    if k2 != WINDOW or not torch.equal(g, tuned_grid):
        raise AssertionError(f"fold scatter sort radix: K2 launched {k2} times, max |diff| "
                             f"{float((g - tuned_grid).abs().max())} to the default's grid")
    print(f"  fold scatter sort radix: K2 {WINDOW} a window, grid bit-equal to the default's",
          flush=True)


def serving_sweep_phase(smi: str) -> None:
    """(d) ``autotune --serving``: frames/s at 8 points at 1440x1920 (both
    backbones, OS 8 and 16, scales 1.0 and 0.5), then quality at one point
    on the golden scene with a capped training run."""
    t0 = time.perf_counter()
    out = SERVING / "serving.yaml"
    result = cli_main(["autotune", "--serving", "--no-quality", "--out", str(out),
                       "--backbones", "resnext50_32x4d,resnet50", "--strides", "8,16",
                       "--scales", "1.0,0.5", "--upsample", "off", "--window", str(WINDOW),
                       "--windows", "1", "--repeats", "1", "--json",
                       str(SERVING / "serving_fps.json")])
    rows = result["rows"]
    print(f"serving sweep: {len(rows)} points in {time.perf_counter() - t0:.1f} s on {smi}",
          flush=True)
    for r in rows:
        print(f"  {r}", flush=True)
    if len(rows) != 8 or any(not r["fps"] > 0 for r in rows) or out.exists():
        raise AssertionError(f"serving fps sweep: {rows} (an fps-only sweep writes no overlay)")
    t0 = time.perf_counter()
    result = cli_main(["autotune", "--serving", "--out", str(out), "--backbones", "resnet50",
                       "--strides", "16", "--scales", "0.1", "--upsample", "off", "--window",
                       str(WINDOW), "--windows", "1", "--repeats", "1", "--scene-dir",
                       str(SERVING / "scene"), "--train-steps", "300", "--json",
                       str(SERVING / "serving_quality.json")])
    rec = result["recommended"]
    print(f"serving quality point in {time.perf_counter() - t0:.1f} s on {smi}: {result['rows']}; "
          f"partial {result['partial']}; overlay:\n{out.read_text() if out.exists() else None}",
          flush=True)
    if result["partial"] or rec is None or not out.exists() or not rec["miou"] > 0.5:
        raise AssertionError(f"serving quality point: {result}")


def serving_tools_phase(smi: str) -> dict:
    """Phase 10 (a)-(d), after phase 9(d).  (b) and (c) rebuild phase 3's
    network from phase 5's ``weights.pth`` and its window from the same
    seed.  Returns K3's kernels-line entry for (a)'s window."""
    shutil.rmtree(SERVING, ignore_errors=True)
    SERVING.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(SERVING / "main")
    pipeline = FusedFramePipeline(cfg, load_weights(str(CLI / "weights.pth")),
                                  compute_dtype=torch.bfloat16, distortion="points", device="cuda")
    frames = make_window(cfg, seed=100)
    k3 = xception_phase(smi)
    clock_a = time.perf_counter()
    compile_phase(pipeline, frames, smi)
    clock_b = time.perf_counter()
    autotune_phase(pipeline, frames, smi)
    clock_c = time.perf_counter()
    serving_sweep_phase(smi)
    print(f"phase 10: (a) {clock_a - t0:.1f} s, (b) {clock_b - clock_a:.1f} s, (c) "
          f"{clock_c - clock_b:.1f} s, (d) {time.perf_counter() - clock_c:.1f} s", flush=True)
    return k3


# -- phase 11: parallel replay ---------------------------------------------------------
PARALLEL = REPO / "build" / "chip_smoke_parallel"
# (e): the full-route grid of ref README.md:173-177, 5x5000x7000 f32 at 0.2 m
FULL_ROUTE = {"BOUNDARY": [[0, 1000], [0, 1400]], "RESOLUTION": 0.2, "UPDATE_WINDOW": 512}


def parallel_cfg(name: str, grid_shards: int = 1, **mapping):
    """The main path's mapping configuration with ``GRID_SHARDS`` and other
    ``MAPPING`` keys set, writing under ``build/chip_smoke_parallel/``."""
    cfg = get_cfg_defaults()
    cfg.OUTPUT_DIR = str(PARALLEL / name)
    cfg.MAPPING.GRID_SHARDS = grid_shards
    for key, value in mapping.items():
        setattr(cfg.MAPPING, key, value)
    return cfg


def timed(fn):
    """``fn()`` and its seconds, host clock, synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(what: str, fn, k2: int, k1: int = 0, repeats: int = 3):
    """Run ``fn`` with the launch counts zeroed just before and read just
    after (K2 ``k2`` and K1 ``k1`` times, nothing else), then ``repeats``
    times more.  Returns the first run's result and every run's seconds."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out, seconds = timed(fn)
    check_launches(what, launches_now(), k4=0, k2=k2, k1=k1)
    return out, [seconds] + [timed(fn)[1] for _ in range(repeats)]


def map_of(grid) -> np.ndarray:
    return render.unpack_rgba_image(render.render_bev_map_fused(grid, LABEL_COLORS)).cpu().numpy()


def fps(seconds: list, frames: int = WINDOW) -> str:
    """Frames/s of each run of ``frames`` frames, the counted run first."""
    return f"{', '.join(f'{frames / t:.3f}' for t in seconds)} frames/s"


def parallel_cli(ref: dict, smi: str) -> None:
    """(a) ``replay --frame-parallel`` on the card's own mesh; with
    ``--save-grid``/``--resume-grid`` over two halves."""
    weights = CLI / "weights.pth"

    def replay(name, *args):
        return cli_main(["replay", "--cfg", overlay(name, weights), "--frame-parallel", *args])

    _, seconds = counted("CLI replay --frame-parallel", lambda: replay(
        "replay_fp", "--input-dir", str(CLI / "replay_all"),
        "--save-grid", str(CLI / "replay_fp_grid.npz")), k2=WINDOW, k1=1, repeats=0)
    with np.load(CLI / "replay_fp_grid.npz") as z:
        grid = torch.from_numpy(z["grid"]).cuda()
    print(f"11(a) CLI replay --frame-parallel over {[str(d) for d in local_devices('cuda')]}: "
          f"{fps(seconds)}, the whole call (load, stage, fuse, psum, render, save) on {smi}; "
          f"launches K2 {WINDOW}, K1 1", flush=True)
    compare_with_plain("11(a) CLI replay --frame-parallel", grid,
                       written_map("replay_fp", "global_map_combined.png"), ref["grid"],
                       ref["map"], against="phase 5's sequential replay")
    replay("replay_fp_first", "--input-dir", str(CLI / "replay_first"),
           "--save-grid", str(CLI / "fp_first_half.npz"))
    replay("replay_fp_second", "--input-dir", str(CLI / "replay_second"),
           "--resume-grid", str(CLI / "fp_first_half.npz"), "--save-grid", str(CLI / "fp_both.npz"))
    with np.load(CLI / "fp_both.npz") as z:
        resumed = torch.from_numpy(z["grid"]).cuda()
    diff = float((resumed - grid).abs().max())
    print(f"11(a) --frame-parallel --save-grid then --resume-grid over two halves against one "
          f"run: grid max |diff| {diff}", flush=True)
    if not torch.allclose(resumed, grid, atol=1e-3):
        raise AssertionError(f"resumed frame-parallel replay differs from one run by {diff}")


def parallel_logical(frames: list, ref: dict, smi: str) -> None:
    """(b) ``run_frames_parallel`` over 4 and 3 logical shards of cuda:0 (3
    pads one no-op frame), against the sequential grid and its plain run."""
    for n in (4, 3):
        what = f"11(b) frame-parallel over {n} logical shards of cuda:0"
        replay = MappingReplay(parallel_cfg(f"fp{n}"), device="cuda", devices=["cuda:0"] * n,
                               frame_parallel=True)
        padded = -(-len(frames) // n) * n
        grid, seconds = counted(what, lambda: replay.run_frames_parallel(frames), k2=padded)
        print(f"{what}: {fps(seconds)} on {smi}; launches K2 {padded} ({padded - len(frames)} "
              "no-op frames)", flush=True)
        color_map = map_of(grid)
        compare_with_plain(what, grid, color_map, ref["grid"], ref["map"],
                           against="phase 5's sequential replay")
        with K.plain_versions():
            plain = replay.run_frames_parallel(frames)
            plain_map = map_of(plain)
        compare_with_plain(what, grid, color_map, plain, plain_map)


def parallel_grid_shards(frames: list, ref: dict, smi: str, route: bool = False) -> None:
    """(c) ``MAPPING.GRID_SHARDS`` 4 over 4 logical shards of cuda:0, without
    a window and with the main path's lossy 1100-cell window (slabs straddle
    the 500-row bands); (e) with ``route``: the full-route 5x5000x7000 grid,
    ``UPDATE_WINDOW`` 512, 4 bands of 175 MB.  Each against the unsharded
    replay at its configuration (without a window: the sequential
    ``run_frames`` of phase 5's replay)."""
    configs = [("11(e) full route", FULL_ROUTE)] if route else [
        ("11(c) GRID_SHARDS 4", {"UPDATE_WINDOW": 0}),
        ("11(c) GRID_SHARDS 4, UPDATE_WINDOW 1100", {"UPDATE_WINDOW": 1100})]
    for i, (what, mapping) in enumerate(configs):
        tag = f"{'route' if route else 'gs'}{i}"
        one = MappingReplay(parallel_cfg(f"{tag}_1", **mapping), device="cuda")
        want, seconds_1 = counted(f"{what}, unsharded", lambda: one.run_frames(frames), k2=WINDOW)
        replay = MappingReplay(parallel_cfg(f"{tag}_4", 4, **mapping), device="cuda",
                               devices=["cuda:0"] * 4)
        got, seconds_4 = counted(what, lambda: replay.run_frames(frames), k2=4 * WINDOW)
        bands = [f"{tuple(b.shape)} {b.numel() * 4 / 1e6:.1f} MB on {b.device}" for b in got.bands]
        grid = got.gather("cuda")
        diff = float((grid - want).abs().max())
        print(f"{what}: {fps(seconds_4)} against the unsharded replay's {fps(seconds_1)} on "
              f"{smi}; launches K2 {4 * WINDOW} (unsharded {WINDOW}); bands {bands}; grid "
              f"{tuple(grid.shape)} against the unsharded: max |diff| {diff}, sum "
              f"{float(grid.sum()):.1f}", flush=True)
        if not torch.allclose(grid, want, atol=1e-4) or float(grid.sum()) <= 0:
            raise AssertionError(f"{what}: sharded grid differs from the unsharded by {diff}")
        if not route and not mapping["UPDATE_WINDOW"]:
            compare_with_plain(what, grid, map_of(grid), ref["grid"], ref["map"],
                               against="phase 5's sequential replay")
        del want, got, grid
        torch.cuda.empty_cache()


def parallel_composed(frames: list, ref: dict, smi: str) -> None:
    """(d) frames over 2 'data' shards and grid rows over 2 'grid' shards of
    cuda:0, one psum per band."""
    what = "11(d) frame-parallel x GRID_SHARDS 2 over a (2, 2) mesh of cuda:0"
    replay = MappingReplay(parallel_cfg("composed", 2), device="cuda", devices=["cuda:0"] * 4,
                           frame_parallel=True)
    got, seconds = counted(what, lambda: replay.run_frames_parallel(frames), k2=2 * WINDOW)
    grid = got.gather("cuda")
    print(f"{what}: {fps(seconds)} on {smi}; launches K2 {2 * WINDOW}; bands "
          f"{[tuple(b.shape) for b in got.bands]}", flush=True)
    compare_with_plain(what, grid, map_of(grid), ref["grid"], ref["map"],
                       against="phase 5's sequential replay")


def parallel_phase(smi: str) -> None:
    """Phase 11: parallel replay at full width over phase 5's 8
    pre-segmented 1440x1920 frames (bucket 2**17, the 5x2000x2000 grid),
    against phase 5's sequential ``replay`` grid."""
    shutil.rmtree(PARALLEL, ignore_errors=True)
    PARALLEL.mkdir(parents=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print("phase 11: frames/s on the host clock, synchronised at both ends, a run of "
          f"{WINDOW} frames each: the counted run first, then (b)-(e) three more", flush=True)
    frames = load_frames(str(CLI / "replay_all" / "labels.npz"))
    with np.load(CLI / "replay_grid.npz") as z:
        ref = {"grid": torch.from_numpy(z["grid"]).cuda(),
               "map": written_map("replay", "global_map_combined.png")}
    parallel_cli(ref, smi)
    parallel_logical(frames, ref, smi)
    parallel_grid_shards(frames, ref, smi)
    parallel_composed(frames, ref, smi)
    parallel_grid_shards(frames, ref, smi, route=True)
    print(f"phase 11 (parallel replay) {time.perf_counter() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


# -- phase 12: data-parallel training -------------------------------------------------
DP = REPO / "build" / "chip_smoke_dp"
DP_RANKS = 2
DP_TIMEOUT = 900    # seconds a group of ranks, or the torchrun command, may take
DP_HALF = TRAIN_BATCH // DP_RANKS
# 12(a), one step at full width in f32 from the same weights, two ranks against
# one process (and per-device on identical halves against global-batch):
# - the loss within 1e-4 relative: the global-batch BatchNorm's statistics
#   (E[x^2] - E[x]^2, summed over two halves) against cuDNN's, 60 layers deep;
# - every parameter within 5e-2 of the step's largest parameter update: one
#   process's own f32 gradient of this random-weight network lies up to 1.3e-2
#   from its f64 value (measured on the CPU at a global batch of 8), and the
#   two sides differed by 1.2e-2 and 1.5e-2 of it on an H100 80GB HBM3 at
#   700 W; a missing or doubled reduction moves a parameter by half its update;
# - every running statistic within 1e-4 of its tensor's largest value (a tenth
#   of the batch statistics' f32 rounding, accumulated over 60 layers);
# - the confusion: at most 1e-4 of the pixels change cell.  A pixel whose two
#   largest logits lie within the two sides' rounding changes class (99
#   pixels in 62 cells, two ranks against one process, on an H100 80GB HBM3
#   at 700 W; 144 pixels on identical halves), where a wrong statistic or a missing
#   sum over ranks moves a share of the pixels of the order of 1.
DP_LOSS_RTOL, DP_PARAM_TOL, DP_STAT_TOL, DP_MOVED_TOL = 1e-4, 5e-2, 1e-4, 1e-4
# 12(c): per-step losses of the one-rank NCCL world against one process,
# relative, as printed (4 decimals): cuDNN's backward is not deterministic
# from run to run, the weights after a step differ by its rounding
DP_TORCHRUN_RTOL = 1e-3


def dp_cfg():
    """example_train.yaml for 12(a): deterministic crops, no dropout (one
    process and two ranks draw different masks)."""
    cfg = get_train_cfg_defaults()
    cfg.merge_from_file(str(REPO / "configs" / "example_train.yaml"))
    cfg.merge_from_list(["DATASET.ROOT_DIR", str(TRAIN / "data"), "TRAIN.AUGMENTATION", VAL_AUG,
                         "MODEL.ASPP.DROPOUT", "0.0", "DATALOADER.NUM_WORKERS", "8"])
    return cfg


def dp_state(cfg, init: dict) -> TrainState:
    model, *_ = build_train_model(cfg, device="cuda:0")
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    return TrainState(model, opt, build_scheduler(opt, build_schedule(cfg)),
                      torch.Generator("cuda:0").manual_seed(1))


def dp_host_state(state: TrainState) -> dict:
    return {k: v.detach().cpu() for k, v in state.model.state_dict().items()}


def dp_diff(a: dict, b: dict, init: dict) -> dict:
    """Largest parameter difference (and the largest update, b - init), and
    the largest running-statistic difference as a share of its tensor's
    largest value."""
    params = [k for k in a if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]
    stats = [k for k in a if k.endswith(("running_mean", "running_var"))]
    return {
        "param": max(float((a[k] - b[k]).abs().max()) for k in params),
        "update": max(float((b[k] - init[k]).abs().max()) for k in params),
        "stat": max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
                    for k in stats),
    }


def dp_check(what: str, d: dict, loss_a: float, loss_b: float) -> None:
    ok = (abs(loss_a - loss_b) <= DP_LOSS_RTOL * abs(loss_b)
          and d["param"] <= DP_PARAM_TOL * d["update"] and d["stat"] <= DP_STAT_TOL)
    print(f"{what}: loss {loss_a!r} against {loss_b!r} (|diff| {abs(loss_a - loss_b):.3e}, "
          f"tolerance {DP_LOSS_RTOL} relative); parameters max |diff| {d['param']:.3e} "
          f"(tolerance {DP_PARAM_TOL} x the largest update {d['update']:.3e}); running "
          f"statistics max |diff| {d['stat']:.3e} of their tensor's largest (tolerance "
          f"{DP_STAT_TOL})", flush=True)
    if not ok:
        raise AssertionError(f"{what}: outside the tolerances")


def dp_rank_steps(spec: dict, rank: int) -> dict:
    """(a) on one rank: the global-batch step on this rank's half, counted and
    timed; the gradient all-reduce timed; then the global-batch and the
    per-device step on identical halves (rank 0's half on both ranks)."""
    cfg = dp_cfg()
    init = torch.load(DP / "init.pt")
    batch = torch.load(DP / "batch.pt")
    group = dist.group.WORLD

    def half(i):
        return {k: v[i * DP_HALF:(i + 1) * DP_HALF].to("cuda:0") for k, v in batch.items()}

    state = dp_state(cfg, init)
    step = make_train_step(19, group=group)
    mine = half(rank)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    m = step(state, mine)
    launches = launches_now()
    step_s = time.perf_counter() - t0
    grads = [p.grad.clone() for p in state.model.parameters() if p.grad is not None]
    reduce_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_(grads, group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    grad_mb = sum(g.numel() * g.element_size() for g in grads) / 2 ** 20
    # one BatchNorm all-reduce alone ([sum x, sum x^2, n] of 256 channels),
    # of which the global-batch step runs one a BatchNorm forward and backward
    norms = sum(isinstance(mod, BatchNorm2d) for mod in state.model.modules())
    stats = torch.zeros(2 * 256 + 1, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        dist.all_reduce(stats, group=group)
        torch.cuda.synchronize()
    bn_ms = (time.perf_counter() - t0) / 50 * 1e3
    out = {"loss": float(m["loss"]), "launches": launches, "step_s": step_s,
           "reduce_ms": reduce_ms, "grad_mb": grad_mb, "grad_tensors": len(grads),
           "norms": norms, "bn_ms": bn_ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if rank == 0:
        torch.save({"loss": float(m["loss"]), "confusion": m["confusion"].cpu(),
                    "state": dp_host_state(state)}, DP / "a_rank0.pt")
    del state, step, grads, m
    torch.cuda.empty_cache()
    same = half(0)
    runs = {}
    for name, make in (("global", lambda: make_train_step(19, group=group)),
                       ("per_device", lambda: make_per_device_bn_train_step(19, group))):
        state = dp_state(cfg, init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = make()(state, same)
        torch.cuda.synchronize()
        runs[name] = (float(m["loss"]), dp_host_state(state), time.perf_counter() - t0,
                      m["confusion"].cpu())
        del state, m
        torch.cuda.empty_cache()
    (lg, sg, tg, cg), (lp, sp, tp, cp) = runs["global"], runs["per_device"]
    out.update({"same": dp_diff(sp, sg, init), "same_loss": (lp, lg),
                "same_moved": float((cg - cp).abs().sum()) / 2, "same_pixels": float(cg.sum()),
                "same_step_s": {"global": tg, "per_device": tp}})
    return out


def dp_rank_train(spec: dict, rank: int) -> dict:
    """(b) on one rank: ``main(["train", "--distributed", ...])`` per run, with
    the launches, peak memory and checkpoint files of each."""
    writes = []
    write = Checkpoint._write
    Checkpoint._write = staticmethod(lambda path, payload: (writes.append(path),
                                                            write(path, payload)))
    out = {}
    for name, argv in spec["runs"]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli_main(argv)
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0, "history": trainer.history,
                     "launches": launches_now(), "best": trainer.best_metric,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "checkpoints": [Path(p).name for p in writes],
                     "route": trainer._train_step.__qualname__.split(".")[0]}
        writes.clear()
        del trainer
        torch.cuda.empty_cache()
    return out


def rank_worker(spec_path: str) -> None:
    """One rank of phase 12 or 14: join the gloo group the phase opened on
    the card and run the task; the result as JSON beside the spec."""
    spec = json.loads(Path(spec_path).read_text())
    torch.cuda.set_device(0)
    resolve_device("cuda:0")  # TF32 off
    rank = spec["rank"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{spec['port']}",
                            world_size=spec["world"], rank=rank,
                            timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        result = RANK_TASKS[spec["task"]](spec, rank)
    finally:
        dist.destroy_process_group()
    Path(spec["out"]).write_text(json.dumps(result))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(task: str, where: Path = DP, world: int = DP_RANKS, timeout: int = DP_TIMEOUT,
              **spec) -> list:
    """Start ``world`` ranks of ``task`` (processes on cuda:0 over gloo),
    wait for all within ``timeout`` seconds; any rank failing fails the
    phase."""
    port = free_port()
    procs = []
    for rank in range(world):
        path = where / f"{task}_rank{rank}.spec.json"
        path.write_text(json.dumps({"task": task, "rank": rank, "port": port, "world": world,
                                    "timeout": timeout,
                                    "out": str(where / f"{task}_rank{rank}.json"), **spec}))
        log = open(where / f"{task}_rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"),
                                        "--rank-worker", str(path)], stdout=log,
                                       stderr=subprocess.STDOUT, start_new_session=True), log))
    wait_all(task, procs, timeout)
    return [json.loads((where / f"{task}_rank{r}.json").read_text()) for r in range(world)]


def wait_all(what: str, procs: list, timeout: int = DP_TIMEOUT) -> None:
    """Wait for every process (and its session) until ``timeout``; kill
    what is left; raise with the log's end if any failed."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    bad = [(i, p.returncode) for i, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = {i: Path(log.name).read_text()[-4000:] for i, (_, log) in enumerate(procs)}
        raise RuntimeError(f"{what}: processes {bad} failed or timed out after {timeout} s:"
                           f" {tails}")


def dp_steps_phase(smi: str) -> None:
    """(a) One global-batch step on two ranks against one process."""
    cfg = dp_cfg()
    loader = build_dataloader(cfg, mode="train")
    host = next(iter(loader))
    batch = {"image": torch.from_numpy(np.asarray(host["image"], np.float32)),
             "label": torch.from_numpy(np.asarray(host["label"]).astype(np.int64))}
    torch.save(batch, DP / "batch.pt")
    model, *_ = build_train_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(init, DP / "init.pt")
    del model
    state = dp_state(cfg, init)
    t0 = time.perf_counter()
    ref = make_train_step(19)(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref_loss, ref_cm, ref_state = float(ref["loss"]), ref["confusion"].cpu(), dp_host_state(state)
    del state, ref
    torch.cuda.empty_cache()
    ranks = run_group("a")
    got = torch.load(DP / "a_rank0.pt")
    print(f"12(a) one global-batch step, ResNeXt50-32x4d OS16 f32 (TF32 off), batch 16 of "
          f"513x513 as 2 ranks x {DP_HALF} on cuda:0 over gloo, against one process on {smi} "
          "(two ranks on one card measure the rank machinery, not multi-card speed):",
          flush=True)
    moved = float((got["confusion"] - ref_cm).abs().sum()) / 2
    print(f"  confusion: {moved:.0f} of {float(ref_cm.sum()):.0f} pixels change cell "
          f"(tolerance {DP_MOVED_TOL} of them; cells differing "
          f"{int((got['confusion'] != ref_cm).sum())}, largest |diff| "
          f"{float((got['confusion'] - ref_cm).abs().max())})", flush=True)
    dp_check("  2 ranks against one process", dp_diff(got["state"], ref_state, init),
             got["loss"], ref_loss)
    for r, res in enumerate(ranks):
        launches = {k: v for k, v in res["launches"].items() if v}
        print(f"  rank {r}: step {res['step_s'] * 1e3:.1f} ms host clock (one process, batch "
              f"16: {ref_s * 1e3:.1f} ms, the first of its run); launches {launches} (one "
              f"process at batch 16: K4 16, K3 48); gradient all-reduce of {res['grad_tensors']}"
              f" tensors, {res['grad_mb']:.1f} MiB in one flat buffer: "
              f"{', '.join(f'{v:.1f}' for v in res['reduce_ms'])} ms; one BatchNorm "
              f"all-reduce (513 floats) {res['bn_ms']:.3f} ms alone, x {2 * res['norms']} "
              f"a global-batch step ({res['norms']} BatchNorms, forward and backward) = "
              f"{2 * res['norms'] * res['bn_ms']:.1f} ms; peak memory "
              f"{res['peak_gib']:.2f} GiB; identical halves: global step "
              f"{res['same_step_s']['global'] * 1e3:.1f} ms, per-device "
              f"{res['same_step_s']['per_device'] * 1e3:.1f} ms", flush=True)
        want = {"aspp_depthwise3x3_multi": DP_HALF, "depthwise3x3_dilated": 3 * DP_HALF}
        if launches != want:
            raise AssertionError(f"12(a) rank {r}: launches {launches} != {want}")
        if abs(res["loss"] - got["loss"]) != 0:
            raise AssertionError(f"12(a): the ranks report different losses")
    same = ranks[0]
    dp_check("  per-device step on identical halves against the global-batch step",
             same["same"], *same["same_loss"])
    print(f"  identical halves: {same['same_moved']:.0f} of {same['same_pixels']:.0f} pixels "
          f"change cell in the confusion (tolerance {DP_MOVED_TOL} of them)", flush=True)
    if max(moved / float(ref_cm.sum()), same["same_moved"] / same["same_pixels"]) > DP_MOVED_TOL:
        raise AssertionError("12(a): confusion differs")


def dp_train_argv(out: Path, epochs: int, *extra) -> list:
    return ["train", "--cfg", str(REPO / "configs" / "example_train.yaml"),
            "DATASET.ROOT_DIR", str(TRAIN / "data"), "OUTPUT_DIR", str(out),
            "SCHEDULER.MAX_EPOCH", str(epochs), "DATALOADER.NUM_WORKERS", "4",
            "TRAIN.AUGMENTATION", TRAIN_AUG, "VALIDATE.AUGMENTATION", VAL_AUG, *extra]


def dp_train_phase(smi: str) -> None:
    """(b) ``main(["train", "--distributed", ...])`` on two ranks of cuda:0:
    example_train.yaml as it stands (per-device BatchNorm, K = 8), resumed
    by AUTO_RESUME, then with SYNC_BN True."""
    device = ["--device", "cuda", "--distributed"]
    runs = [("per-device", dp_train_argv(DP / "per_device", 4, *device)),
            ("per-device resumed (AUTO_RESUME)", dp_train_argv(DP / "per_device", 5, *device)),
            ("SYNC_BN True", dp_train_argv(DP / "sync", 4, "MODEL.SYNC_BN", "True", *device))]
    ranks = run_group("b", runs=runs)
    val_frames = sum(1 for _ in (TRAIN / "data" / "validation" / "images").iterdir())
    for name, _ in runs:
        (r0, r1) = (r[name] for r in ranks)
        hist = r0["history"]
        steps = len(hist)
        epochs = steps // 2
        losses = [h["loss"] for h in hist]
        if losses != [h["loss"] for h in r1["history"]] or not np.isfinite(losses).all():
            raise AssertionError(f"12(b) {name}: the ranks' losses differ or are not finite")
        batch_t = np.median([h["batch_time"] for h in hist])
        print(f"12(b) train --distributed, {name}, 2 ranks on cuda:0 over gloo ({r0['route']}): "
              f"{steps} steps (steps {hist[0]['step']}-{hist[-1]['step']}), {r0['seconds']:.1f} s "
              f"command time on {smi}; median step {batch_t * 1e3:.1f} ms = {1 / batch_t:.3f} "
              f"steps/s = {TRAIN_BATCH / batch_t:.2f} images/s (host clock between steps, rank 0)",
              flush=True)
        print(f"  loss per step: {[round(v, 4) for v in losses]}; best val mIoU {r0['best']:.4f}",
              flush=True)
        for r, res in enumerate((r0, r1)):
            data_t = np.median([h["data_time"] for h in res["history"]])
            launches = {k: v for k, v in res["launches"].items() if v}
            want = {"aspp_depthwise3x3_multi": DP_HALF * steps + val_frames // 2 * epochs,
                    "depthwise3x3_dilated": 3 * DP_HALF * steps}
            print(f"  rank {r}: median host wait for data {data_t * 1e3:.1f} ms a step; peak "
                  f"memory allocated {res['peak_gib']:.2f} GiB; launches {launches} (K4 "
                  f"{DP_HALF} x {steps} steps + {val_frames // 2} x {epochs} validation frames, "
                  f"K3 {3 * DP_HALF} x {steps}); checkpoints written {res['checkpoints']}",
                  flush=True)
            if launches != want:
                raise AssertionError(f"12(b) {name} rank {r}: launches {launches} != {want}")
        if not r0["checkpoints"] or r1["checkpoints"]:
            raise AssertionError(f"12(b) {name}: checkpoints written by rank 1 or by no rank")
    first = len(ranks[0][runs[0][0]]["history"])
    for r, res in enumerate(ranks):
        steps = [h["step"] for h in res[runs[1][0]]["history"]]
        if steps != [first + 1, first + 2]:
            raise AssertionError(f"12(b) rank {r}: the resume took steps {steps} after {first}")
    for name in ("per-device", "SYNC_BN True"):
        losses = [h["loss"] for h in ranks[0][name]["history"]]
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            raise AssertionError(f"12(b) {name}: the loss did not fall: {losses}")


def dp_torchrun_phase(smi: str) -> None:
    """(c) ``torchrun --nproc-per-node 1 -m vision_semantic_segmentation_tpu_torch
    train --distributed``, a one-rank NCCL world, against the same command in
    this process; per-step losses as the log prints them (each epoch's running
    mean, LOG_PERIOD 1)."""
    extra = ("TRAIN.LOG_PERIOD", "1", "DATALOADER.NUM_WORKERS", "0", "RNG_SEED", "1")
    argv = dp_train_argv(DP / "torchrun", 1, *extra)[1:]
    log = open(DP / "torchrun.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", "1", "-m",
                             "vision_semantic_segmentation_tpu_torch", "train", "--distributed",
                             *argv], stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                            start_new_session=True)
    wait_all("12(c) torchrun", [(proc, log)])
    seconds = time.perf_counter() - t0
    text = (DP / "torchrun.log").read_text()
    printed = [float(v) for v in re.findall(r"iter\[\d+\] lr [\d.]+ loss: [\d.]+ \(([\d.]+)\)",
                                             text)]
    if "over nccl" not in text:
        raise AssertionError("12(c): the torchrun world did not run over NCCL")
    one = cli_main(["train", *dp_train_argv(DP / "one_process", 1, *extra)[1:],
                    "--device", "cuda"])
    want = []
    for h in one.history:
        run = [g["loss"] for g in one.history if g["epoch"] == h["epoch"]
               and g["step"] <= h["step"]]
        want.append(float(np.mean(run)))
    print(f"12(c) torchrun --nproc-per-node 1 ... train --distributed (NCCL, one rank) on {smi}: "
          f"{seconds:.1f} s command time; running mean loss per step {printed} against one "
          f"process's {[round(v, 4) for v in want]} (tolerance {DP_TORCHRUN_RTOL} relative)",
          flush=True)
    if len(printed) != len(want) or not np.allclose(printed, want, rtol=DP_TORCHRUN_RTOL,
                                                    atol=5e-5):
        raise AssertionError("12(c): the one-rank NCCL world's losses differ from one process")
    del one
    torch.cuda.empty_cache()


def data_parallel_phase(smi: str) -> None:
    """Phase 12: data-parallel training (``parallel/distributed.py``, the
    data-parallel steps, ``train --distributed``) at full width."""
    shutil.rmtree(DP, ignore_errors=True)
    DP.mkdir(parents=True)
    t0 = time.perf_counter()
    dp_steps_phase(smi)
    dp_train_phase(smi)
    dp_torchrun_phase(smi)
    print(f"phase 12 (data-parallel training) {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 13: spatial sharding at full width ----------------------------------------
SPATIAL = REPO / "build" / "chip_smoke_spatial"
SPATIAL_SHARDS = 4
# Banded and unbanded forwards are one arithmetic but for the convolutions'
# algorithms, which cuDNN picks per shape: in f32 (TF32 off) an output sums
# its terms in another order (about 1e-6 relative); in bf16 every activation
# rounds to 8 bits (2^-8), so a last-bit difference in one layer moves the
# roundings after it.  Labels then differ only at near-ties of the two top
# classes.  A broken halo garbles whole rows at every band edge (3 edges x
# tens of rows of a 176-row label map: more than 5 % of the pixels), far
# above these shares.
SPATIAL_LABEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}  # share of pixels
# of the unsharded logits' largest |value|: bf16 as SERVE_TOL (2^-4, 16
# blocks of 2^-8 roundings), f32 a thousand f32 roundings deep
SPATIAL_LOGIT_TOL = {torch.bfloat16: 2.0 ** -4, torch.float32: 1e-4}
# (b): the grid folds 8 frames of 10**5 points each into 4 M cells; a label
# that flips moves one point's evidence to another class
SPATIAL_MAP_TOL = 1e-3   # share of the rendered map's cells that differ
SPATIAL_GRID_TOL = 1e-3  # share of the grid's cells whose evidence differs by > 1e-3
# (e): tests/test_spatial_train.py::_assert_matches' envelope for train-mode
# BatchNorm in f32 (loss absolute, confusion cell as a share of the pixels
# with equal totals, running statistics absolute, parameters as a share of
# max(1, their largest)).  Eval-mode gradients per leaf of its largest value,
# in f64 (the plain versions): in f32 a BatchNorm bias's gradient sums about
# 8 M terms that cancel to a small total, and one f32 sum over all of them
# can lie a fifth from its f64 value (one process's, on the H100); a broken
# halo would move every conv's gradient upstream of it
SPATIAL_TRAIN_TOL = {"loss": 2e-4, "cell": 1e-2, "stats": 5e-3, "param": 5e-2}
SPATIAL_GRAD_RTOL = 1e-3
SPATIAL_TRAIN_SHARDS = 3  # 513-row crops: 171 rows a band (4 does not divide 513)


def spatial_agreement(what: str, base: SemanticSegmentation, banded: SemanticSegmentation,
                      image, dtype) -> None:
    """Labels and logits of the banded predictor against the unsharded one."""
    want, got = base.logits(image), banded.logits(image)
    scale = float(want.float().abs().max())
    logit_err = float((got.float() - want.float()).abs().max()) / scale
    differ = float((got.argmax(-1) != want.argmax(-1)).float().mean())
    labels = banded.segmentation(image)
    same = bool(np.array_equal(labels, base.segmentation(image)))
    print(f"  {what}: labels differ on {differ:.3e} of the pixels (tolerance "
          f"{SPATIAL_LABEL_TOL[dtype]}; segmentation() equal: {same}), logits max |diff| "
          f"{logit_err:.3e} of the largest |logit| {scale:.3f} (tolerance "
          f"{SPATIAL_LOGIT_TOL[dtype]})", flush=True)
    if differ > SPATIAL_LABEL_TOL[dtype] or logit_err > SPATIAL_LOGIT_TOL[dtype]:
        raise AssertionError(f"{what}: banded forward outside the tolerances")


def spatial_time(what: str, predictor: SemanticSegmentation, image, want: dict, smi: str):
    """One frame's launches counted alone, then ms a frame (host clock,
    synchronised, 3 frames) and the peak memory of one frame."""
    predictor.labels(image)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    predictor.labels(image)
    launches = launches_now()
    expected = {k.name: 0 for k in K.kernels()}
    expected.update(want)
    if launches != expected:
        raise AssertionError(f"{what}: launch counts {launches} != expected {expected}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        predictor.labels(image)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {what}: {ms:.2f} ms a frame (host clock, synchronised, 3 frames) on {smi}, "
          f"peak memory allocated {peak:.2f} GiB; launches a frame "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return ms


def spatial_net_cfg(net_cfg, shards: int):
    cfg = net_cfg.clone()
    cfg.MODEL.SPATIAL_SHARDS = shards
    return cfg


def spatial_serving(state: dict, image, smi: str) -> SemanticSegmentation:
    """(a) The main path's network, one raw 1440x1920 frame, 4 bands in bf16
    and f32, 8 bands in f32, against the unsharded predictor.  Returns the
    bf16 4-band predictor."""
    net = online_cfg().VISION_SEM_SEG.SEM_SEG_NETWORK
    dilations = ASPP_DILATIONS
    kept = None
    for dtype, shards in ((torch.bfloat16, 4), (torch.float32, 4), (torch.float32, 8)):
        name = f"{shards} bands {str(dtype).split('.')[-1]}"
        base = SemanticSegmentation(net, state_dict=state, compute_dtype=dtype, device="cuda")
        banded = SemanticSegmentation(spatial_net_cfg(net, shards), state_dict=state,
                                      compute_dtype=dtype, device="cuda",
                                      devices=["cuda:0"] * shards)
        rows = spatial_infer.k4_rows(180, shards, dilations)
        print(f"13(a) {name}: ResNeXt50 OS8 at 1440x1920, {shards} logical shards of cuda:0 "
              f"({spatial_infer.row_bounds(180, shards)} rows of the 180-row OS8 map); K4 reads "
              f"{' + '.join(map(str, rows))} = {sum(rows)} rows against 180 unsharded "
              f"({sum(rows) / 180:.2f}x)", flush=True)
        spatial_agreement(name, base, banded, image, dtype)
        ms0 = spatial_time(f"{name} unsharded", base, image, {"aspp_depthwise3x3_multi": 1},
                           smi)
        ms1 = spatial_time(f"{name} banded", banded, image,
                           {"aspp_depthwise3x3_multi": shards}, smi)
        print(f"  {name}: banded {ms1 / ms0:.2f}x the unsharded frame", flush=True)
        if dtype == torch.bfloat16:
            kept = banded
        del base, banded
        torch.cuda.empty_cache()
    return kept


def spatial_dataflow(banded: SemanticSegmentation, state: dict, smi: str) -> None:
    """(b) SegmentationNode with the 4-band predictor -> MappingNode over
    phase 4's feed, against the same dataflow unsharded."""
    cfg = online_cfg()
    cfg.OUTPUT_DIR = str(SPATIAL)
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    feed = make_online_feed(seed=200)

    def node(predictor):
        def make(bus):
            SegmentationNode(cfg, bus, predictor=predictor)
            return MappingNode(cfg, bus, device="cuda")
        return make

    base = SemanticSegmentation(net, state_dict=state, compute_dtype=torch.bfloat16,
                                device="cuda")
    grid0, map0, _ = online_run("13(b) two-node unsharded", node(base), feed, smi)
    grid, color_map, launches = online_run("13(b) two-node, 4 bands", node(banded), feed, smi)
    check_launches("13(b) two-node, 4 bands", launches, k4=SPATIAL_SHARDS * WINDOW)
    cells = float(((grid - grid0).abs() > 1e-3).any(0).float().mean())
    mismatch = float(np.mean(np.any(np.asarray(color_map) != np.asarray(map0), axis=-1)))
    print(f"13(b): against the unsharded dataflow: grid cells differing by > 1e-3 "
          f"{cells:.3e} (tolerance {SPATIAL_GRID_TOL}), map cells differing {mismatch:.3e} "
          f"(tolerance {SPATIAL_MAP_TOL})", flush=True)
    if cells > SPATIAL_GRID_TOL or mismatch > SPATIAL_MAP_TOL:
        raise AssertionError("13(b): banded dataflow outside the tolerances")
    if not bool(torch.isfinite(grid).all()) or float(grid.sum()) <= 0:
        raise AssertionError("13(b): grid not finite or empty")


def spatial_int8(banded: SemanticSegmentation, state: dict, image, calib: list,
                 smi: str) -> None:
    """(c) The 4-band predictor quantized on 2 frames, served banded (Q1 16
    sites x 4 bands a frame) against the unsharded predictor with its qpack."""
    net = online_cfg().VISION_SEM_SEG.SEM_SEG_NETWORK
    t0 = time.perf_counter()
    banded.quantize(calib)
    print(f"13(c) int8: calibrated on {len(calib)} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    base = SemanticSegmentation(net, state_dict=state, compute_dtype=torch.bfloat16,
                                device="cuda")
    base._set_qpack(banded.qpack)
    spatial_agreement("int8 4 bands", base, banded, image, torch.bfloat16)
    ms0 = spatial_time("int8 unsharded", base, image,
                       {"aspp_depthwise3x3_multi": 1, "int8_conv3x3": 16}, smi)
    ms1 = spatial_time("int8 4 bands", banded, image,
                       {"aspp_depthwise3x3_multi": SPATIAL_SHARDS,
                        "int8_conv3x3": 16 * SPATIAL_SHARDS}, smi)
    print(f"  int8: banded {ms1 / ms0:.2f}x the unsharded frame", flush=True)


def spatial_xception(image, smi: str) -> None:
    """(d) Xception65 OS16 bf16, seeded, BatchNorm statistics from one
    frame, 4 bands against unsharded: K3 60 sites x 4 bands a frame."""
    net = xception_cfg().VISION_SEM_SEG.SEM_SEG_NETWORK
    base = SemanticSegmentation(net, state_dict=build_model(
        net, device="cuda", generator=torch.Generator().manual_seed(7)).state_dict(),
        compute_dtype=torch.bfloat16, device="cuda")
    for m in base.model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
            m.reset_running_stats()
    base.model.train()
    base.labels(image)
    base.model.eval()
    state = base.model.state_dict()
    banded = SemanticSegmentation(spatial_net_cfg(net, SPATIAL_SHARDS), state_dict=state,
                                  compute_dtype=torch.bfloat16, device="cuda",
                                  devices=["cuda:0"] * SPATIAL_SHARDS)
    spatial_agreement("13(d) Xception65 4 bands", base, banded, image, torch.bfloat16)
    ms0 = spatial_time("Xception65 unsharded", base, image,
                       {"depthwise3x3_dilated": XCEPTION_K3_SITES}, smi)
    ms1 = spatial_time("Xception65 4 bands", banded, image,
                       {"depthwise3x3_dilated": XCEPTION_K3_SITES * SPATIAL_SHARDS}, smi)
    print(f"  Xception65: banded {ms1 / ms0:.2f}x the unsharded frame", flush=True)


def spatial_train_cfg():
    cfg = dp_cfg()
    cfg.merge_from_list(["MODEL.SYNC_BN", "True",
                         "TRAIN.SPATIAL_SHARDS", str(SPATIAL_TRAIN_SHARDS)])
    return cfg


def spatial_train_step(smi: str) -> None:
    """(e) One spatial step (data 1 x spatial 3 of cuda:0, f32, TF32 off, no
    dropout) over phase 7's 16 centre crops against the one-process step;
    then one eval-mode gradient against the one-process one."""
    cfg = spatial_train_cfg()
    init = torch.load(DP / "init.pt")
    batch = {k: v.cuda() for k, v in torch.load(DP / "batch.pt").items()}
    mesh = create_mesh((1, SPATIAL_TRAIN_SHARDS), ("data", "spatial"),
                       devices=["cuda:0"] * SPATIAL_TRAIN_SHARDS)
    ref_state = dp_state(cfg, init)
    ref = make_train_step(19)(ref_state, batch)
    want = dp_host_state(ref_state)
    del ref_state
    state = dp_state(cfg, init)
    step = make_spatial_train_step(19, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = step(state, batch)
    launches = launches_now()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    have = dp_host_state(state)
    envelope = spatial_envelope(have, want, float(got["loss"]), float(ref["loss"]),
                                got["confusion"].cpu(), ref["confusion"].cpu())
    print(f"13(e) one spatial train step, ResNeXt50-32x4d OS16 f32 (TF32 off), batch 16 of "
          f"513x513, (data 1, spatial {SPATIAL_TRAIN_SHARDS}) logical shards of cuda:0, against "
          f"one process on {smi}: {envelope}; step {step_s * 1e3:.1f} ms host clock, peak "
          f"memory {peak:.2f} GiB; launches {launches_named(launches)}", flush=True)
    want_launches = {k.name: 0 for k in K.kernels()}
    want_launches.update({"aspp_depthwise3x3_multi": TRAIN_BATCH * SPATIAL_TRAIN_SHARDS,
                          "depthwise3x3_dilated": 3 * TRAIN_BATCH * SPATIAL_TRAIN_SHARDS})
    if launches != want_launches:
        raise AssertionError(f"13(e): launches {launches} != {want_launches}")
    # phase 14 holds its ranks' step to both of these
    torch.save({"unsharded": {"loss": float(ref["loss"]), "confusion": ref["confusion"].cpu(),
                              "state": want},
                "banded": {"loss": float(got["loss"]), "confusion": got["confusion"].cpu(),
                           "state": have}}, SPATIAL / "e_step.pt")
    del state, got, ref
    torch.cuda.empty_cache()

    # eval-mode gradients (running statistics): the backward's halos pinned
    half = {k: v[:4] for k, v in batch.items()}
    grads = {}
    for dtype in (torch.float64, torch.float32):
        for banded in (False, True):
            with (K.plain_versions() if dtype == torch.float64 else contextlib.nullcontext()):
                grads[dtype, banded] = spatial_eval_grads(cfg, init, mesh, half, dtype, banded)
    rel = {dtype: {k: float((grads[dtype, True][k] - a).abs().max())
                   / max(float(a.abs().max()), 1e-30)
                   for k, a in grads[dtype, False].items()}
           for dtype in (torch.float64, torch.float32)}
    worst64 = max(rel[torch.float64].values())
    leaf = max(rel[torch.float32], key=rel[torch.float32].get)
    exact = grads[torch.float64, False][leaf]
    off = [float((grads[torch.float32, b][leaf].double() - exact).abs().max())
           / float(exact.abs().max()) for b in (False, True)]
    print(f"13(e) eval-mode gradient, 4 crops, banded against one process: f64 (plain "
          f"versions) largest per-leaf |diff| {worst64:.3e} of the leaf's largest (tolerance "
          f"{SPATIAL_GRAD_RTOL}); f32 (kernels) {rel[torch.float32][leaf]:.3e} at {leaf}, "
          f"whose f32 gradients lie {off[0]:.3e} (one process) and {off[1]:.3e} (banded) from "
          f"its f64 value (a bias gradient: about 8 M terms that cancel, summed in f32); "
          f"{sum(v > SPATIAL_GRAD_RTOL for v in rel[torch.float32].values())} of "
          f"{len(rel[torch.float32])} f32 leaves above {SPATIAL_GRAD_RTOL}", flush=True)
    if worst64 > SPATIAL_GRAD_RTOL:
        raise AssertionError("13(e): eval-mode gradients differ")
    torch.save({k: g.cpu() for k, g in grads[torch.float64, False].items()},
               SPATIAL / "e_grads64.pt")  # for phase 14(b)
    del grads
    torch.cuda.empty_cache()


def spatial_envelope(have: dict, want: dict, loss: float, ref_loss: float, cm1, cm0) -> str:
    """A banded step's state, loss and confusion against the unsharded
    step's within ``SPATIAL_TRAIN_TOL``: the comparison as one line, or
    raise."""
    loss_d = abs(loss - ref_loss)
    cell = float((cm1 - cm0).abs().max()) / float(cm0.sum())
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    params = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                 "num_batches_tracked"))]
    stat_d = max(float((have[k] - want[k]).abs().max()) for k in stats)
    param_d = max(float((have[k] - want[k]).abs().max())
                  / max(1.0, float(want[k].abs().max())) for k in params)
    line = (f"loss {loss!r} against {ref_loss!r} (|diff| {loss_d:.3e}, tolerance "
            f"{SPATIAL_TRAIN_TOL['loss']}); confusion totals {float(cm1.sum()):.0f} / "
            f"{float(cm0.sum()):.0f}, largest cell |diff| {cell:.3e} of the pixels (tolerance "
            f"{SPATIAL_TRAIN_TOL['cell']}); running statistics max |diff| {stat_d:.3e} "
            f"(tolerance {SPATIAL_TRAIN_TOL['stats']}); parameters max |diff| {param_d:.3e} of "
            f"max(1, their largest) (tolerance {SPATIAL_TRAIN_TOL['param']})")
    if (loss_d > SPATIAL_TRAIN_TOL["loss"] or float(cm1.sum()) != float(cm0.sum())
            or cell > SPATIAL_TRAIN_TOL["cell"] or stat_d > SPATIAL_TRAIN_TOL["stats"]
            or param_d > SPATIAL_TRAIN_TOL["param"]):
        raise AssertionError(f"a banded step outside the tolerances: {line}")
    return line


def launches_named(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def spatial_eval_grads(cfg, init: dict, mesh, batch: dict, dtype, banded: bool) -> dict:
    """The parameters' gradients of the eval-mode (running statistics) loss,
    one process or banded over ``mesh``, in ``dtype``."""
    model = dp_state(cfg, init).model.to(dtype).eval()
    x = batch["image"].to(dtype).permute(0, 3, 1, 2)
    if banded:
        engine = spatial_infer.SpatialModel(model, mesh, spatial_axis="spatial",
                                            data_axis="data")
        labels = spatial_infer.Bands.split(batch["label"], engine.groups, 1)
        loss, _ = spatial_loss(engine(engine.split(x), upsample_pred=True), labels, 19, 255,
                               engine.home)
    else:
        loss = cross_entropy_loss(model(x, upsample_pred=True), batch["label"])
    loss.backward()
    return {k: p.grad.detach().double() for k, p in model.named_parameters()}


def spatial_trainer(smi: str) -> None:
    """(e) ``Trainer(cfg, devices=["cuda:0"] * 3)`` for 4 steps (2 epochs of
    phase 7's 32 frames), against phase 7's one-process run; then the
    command line on the card's one device raises the device-count error."""
    out = SPATIAL / "train"
    shutil.rmtree(out, ignore_errors=True)
    cfg = get_train_cfg_defaults()
    cfg.merge_from_file(str(REPO / "configs" / "example_train.yaml"))
    cfg.merge_from_list(["DATASET.ROOT_DIR", str(TRAIN / "data"), "OUTPUT_DIR", str(out),
                         "SCHEDULER.MAX_EPOCH", "2", "DATALOADER.NUM_WORKERS", "8",
                         "TRAIN.AUGMENTATION", TRAIN_AUG, "VALIDATE.AUGMENTATION", VAL_AUG,
                         "MODEL.SYNC_BN", "True",
                         "TRAIN.SPATIAL_SHARDS", str(SPATIAL_TRAIN_SHARDS)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, output_dir=str(out), device="cuda",
                      devices=["cuda:0"] * SPATIAL_TRAIN_SHARDS)
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    batch_t = np.median([h["batch_time"] for h in hist])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    val_frames = sum(1 for _ in (TRAIN / "data" / "validation" / "images").iterdir())
    want = {k.name: 0 for k in K.kernels()}
    want.update({"aspp_depthwise3x3_multi": SPATIAL_TRAIN_SHARDS * (
                     TRAIN_BATCH * len(hist) + val_frames * 2),
                 "depthwise3x3_dilated": 3 * TRAIN_BATCH * SPATIAL_TRAIN_SHARDS * len(hist)})
    print(f"13(e) Trainer, {SPATIAL_TRAIN_SHARDS} spatial shards of cuda:0, f32: {len(hist)} "
          f"steps in {wall:.1f} s on {smi}; median step {batch_t * 1e3:.1f} ms = "
          f"{1 / batch_t:.3f} steps/s = {TRAIN_BATCH / batch_t:.2f} images/s (host clock "
          f"between steps; phase 7's one-process f32 run above); peak memory allocated "
          f"{peak:.2f} GiB; loss per step {[round(v, 4) for v in losses]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if len(hist) != 4 or launches != want:
        raise AssertionError(f"13(e) Trainer: {len(hist)} steps, launches {launches} != {want}")
    if not (all(np.isfinite(losses)) and np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise AssertionError(f"13(e) Trainer: the loss did not fall: {losses}")
    del trainer
    torch.cuda.empty_cache()
    try:
        cli_main(["train", "--cfg", str(REPO / "configs" / "example_train.yaml"),
                  "DATASET.ROOT_DIR", str(TRAIN / "data"), "OUTPUT_DIR", str(out / "cli"),
                  "MODEL.SYNC_BN", "True", "TRAIN.SPATIAL_SHARDS", str(SPATIAL_TRAIN_SHARDS),
                  "--device", "cuda"])
    except ValueError as exc:
        if "does not divide the device count" not in str(exc):
            raise
        print(f"13(e) train command with TRAIN.SPATIAL_SHARDS {SPATIAL_TRAIN_SHARDS} on "
              f"{torch.cuda.device_count()} card(s): ValueError({exc})", flush=True)
    else:
        raise AssertionError("13(e): the train command took 3 spatial shards on one card")


def spatial_phase(smi: str) -> None:
    """Phase 13: spatial sharding at full width on logical shards of cuda:0.
    They run one band after another on the one card, so the phase measures
    the bands, halos and kernels, not multi-card speed."""
    t0 = time.perf_counter()
    SPATIAL.mkdir(parents=True, exist_ok=True)
    state = load_weights(str(CLI / "weights.pth"))
    feed = make_online_feed(seed=200)
    image = feed[0]["image"]
    banded = spatial_serving(state, image, smi)
    spatial_dataflow(banded, state, smi)
    spatial_int8(banded, state, image, [f["image"] for f in feed[1:3]], smi)
    del banded
    torch.cuda.empty_cache()
    spatial_xception(image, smi)
    torch.cuda.empty_cache()
    spatial_train_step(smi)
    spatial_trainer(smi)
    print(f"phase 13 (spatial sharding) {time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 14: bands across ranks ---------------------------------------------------------
RANKS = REPO / "build" / "chip_smoke_spatial_ranks"
RANKS_WORLD = 6          # (c), (d): data 2 x spatial 3 ranks
RANKS_TIMEOUT = 300      # seconds a group of ranks may take
# (a) holds the ranks' step to 13(e)'s one-process banded step at 12(a)'s
# tolerances (DP_*: the same f32 arithmetic, its sums over the bands taken
# over ranks in another order), and to the unsharded step within
# SPATIAL_TRAIN_TOL, 13(e)'s envelope; (b) holds the f64 eval-mode gradient
# at SPATIAL_GRAD_RTOL, as 13(e) does.


def ranks_steps(spec: dict, rank: int) -> dict:
    """(a) and (b) on one rank of data 1 x spatial 3: the step counted, the
    same step again with each collective timed, the f64 eval-mode
    gradient on the plain versions."""
    cfg = spatial_train_cfg()
    init = torch.load(DP / "init.pt")
    batch = {k: v.to("cuda:0") for k, v in torch.load(DP / "batch.pt").items()}
    world = ensure_distributed("cuda:0")
    groups = world.spatial_groups(SPATIAL_TRAIN_SHARDS)
    traffic = groups.traffic
    out = {}
    for timed in (False, True):
        state = dp_state(cfg, init)
        step = make_spatial_train_step(19, None, group=groups)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        traffic.reset()
        traffic.timed = timed
        K.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        traffic.timed = False
        if timed:
            out.update(timed_s=step_s, seconds=dict(traffic.seconds))
            del state, m
            continue
        out.update(loss=float(m["loss"]), launches=launches_now(), step_s=step_s,
                   calls=dict(traffic.calls), sent=traffic.bytes_sent,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if rank == 0:
            torch.save({"loss": float(m["loss"]), "confusion": m["confusion"].cpu(),
                        "state": dp_host_state(state)}, RANKS / "a_rank0.pt")
        del state, m
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    half = {k: v[:4] for k, v in batch.items()}
    with K.plain_versions():
        model = dp_state(cfg, init).model.double().eval()
        engine = spatial_infer.SpatialModel(model, ranks=groups)
        logits = engine(engine.split(half["image"].double().permute(0, 3, 1, 2)),
                        upsample_pred=True)
        loss, _ = spatial_loss(logits, engine.split(half["label"], 1), 19, 255, engine.home,
                               groups)
        loss.backward()
        all_reduce_([p.grad for p in model.parameters()], world.group)
    if rank == 0:
        torch.save({k: p.grad.detach().cpu() for k, p in model.named_parameters()},
                   RANKS / "b_grads.pt")
    return out


def ranks_refused(spec: dict, rank: int) -> dict:
    """(d) on one rank: the command, and what it raised."""
    try:
        cli_main(spec["argv"])
    except ValueError as exc:
        return {"raised": str(exc)}
    return {"raised": None}


def ranks_steps_phase(smi: str) -> None:
    """(a) One step on 3 ranks against 13(e)'s two steps; (b) the eval-mode
    gradient against 13(e)'s one-process f64 gradient."""
    ranks = run_group("14a", where=RANKS, world=SPATIAL_TRAIN_SHARDS, timeout=RANKS_TIMEOUT)
    got = torch.load(RANKS / "a_rank0.pt")
    ref = torch.load(SPATIAL / "e_step.pt")
    init = torch.load(DP / "init.pt")
    print(f"14(a) one spatial train step, ResNeXt50-32x4d OS16 f32 (TF32 off), batch 16 of "
          f"513x513, data 1 x spatial {SPATIAL_TRAIN_SHARDS} as {SPATIAL_TRAIN_SHARDS} ranks on "
          f"cuda:0 over gloo (NCCL refuses two ranks on one card; the phase measures the "
          f"exchange machinery, not multi-card speed) on {smi}:", flush=True)
    banded = ref["banded"]
    moved = float((got["confusion"] - banded["confusion"]).abs().sum()) / 2
    dp_check("  3 ranks against 13(e)'s one-process banded step",
             dp_diff(got["state"], banded["state"], init), got["loss"], banded["loss"])
    print(f"  confusion against the one-process banded step: {moved:.0f} of "
          f"{float(banded['confusion'].sum()):.0f} pixels change cell (tolerance "
          f"{DP_MOVED_TOL} of them)", flush=True)
    if moved / float(banded["confusion"].sum()) > DP_MOVED_TOL:
        raise AssertionError("14(a): confusion differs from the one-process banded step")
    un = ref["unsharded"]
    print("  3 ranks against the one-process unsharded step: " + spatial_envelope(
        got["state"], un["state"], got["loss"], un["loss"], got["confusion"], un["confusion"]),
        flush=True)
    want = {k.name: 0 for k in K.kernels()}
    want.update({"aspp_depthwise3x3_multi": TRAIN_BATCH,
                 "depthwise3x3_dilated": 3 * TRAIN_BATCH})
    for r, res in enumerate(ranks):
        sec = res["seconds"]
        print(f"  rank {r} (band {r}): step {res['step_s'] * 1e3:.1f} ms host clock (13(e)'s "
              f"one-process banded step above); launches {launches_named(res['launches'])}; "
              f"collective calls a step {res['calls']}; halo bytes sent a step "
              f"{res['sent'] / 2 ** 20:.2f} MiB; with each call timed (the card synchronised "
              f"around it; that step {res['timed_s'] * 1e3:.1f} ms): exchanges "
              f"{sec.get('exchange', 0) * 1e3:.1f} ms forward and "
              f"{sec.get('exchange_backward', 0) * 1e3:.1f} ms backward, all-reduces "
              f"{sec.get('all_reduce', 0) * 1e3:.1f} ms; peak memory {res['peak_gib']:.2f} GiB",
              flush=True)
        if res["launches"] != want:
            raise AssertionError(f"14(a) rank {r}: launches {res['launches']} != {want}")
        if res["calls"] != ranks[0]["calls"] or res["loss"] != ranks[0]["loss"]:
            raise AssertionError("14(a): the ranks made different calls or report other losses")
    print("14: the NCCL point-to-point halos (bands on separate cards) cannot run on this "
          "one-card machine (NCCL refuses two ranks on one card): they wait for a four-chip "
          "run", flush=True)
    want = torch.load(SPATIAL / "e_grads64.pt")
    have = torch.load(RANKS / "b_grads.pt")
    rel = {k: float((have[k] - a).abs().max()) / max(float(a.abs().max()), 1e-30)
           for k, a in want.items()}
    worst = max(rel, key=rel.get)
    print(f"14(b) eval-mode gradient, 4 crops, f64 on the plain versions, 3 ranks against "
          f"13(e)'s one process: largest per-leaf |diff| {rel[worst]:.3e} of the leaf's largest "
          f"at {worst} (tolerance {SPATIAL_GRAD_RTOL})", flush=True)
    if rel[worst] > SPATIAL_GRAD_RTOL:
        raise AssertionError("14(b): eval-mode gradients differ")


def ranks_train_phase(smi: str) -> None:
    """(c) ``main(["train", "--distributed", ..., "TRAIN.SPATIAL_SHARDS",
    "3"])`` on 6 ranks for 4 steps; (d) the same with S = 4 raises on every
    rank."""
    device = ["--device", "cuda", "--distributed"]
    runs = [("data 2 x spatial 3", dp_train_argv(
        RANKS / "train", 2, "MODEL.SYNC_BN", "True", "TRAIN.SPATIAL_SHARDS",
        str(SPATIAL_TRAIN_SHARDS), *device))]
    ranks = run_group("14c", where=RANKS, world=RANKS_WORLD, timeout=RANKS_TIMEOUT, runs=runs)
    val_frames = sum(1 for _ in (TRAIN / "data" / "validation" / "images").iterdir())
    data_groups = RANKS_WORLD // SPATIAL_TRAIN_SHARDS
    name = runs[0][0]
    hist = ranks[0][name]["history"]
    losses = [h["loss"] for h in hist]
    batch_t = np.median([h["batch_time"] for h in hist])
    print(f"14(c) train --distributed ... TRAIN.SPATIAL_SHARDS {SPATIAL_TRAIN_SHARDS}, "
          f"{RANKS_WORLD} ranks ({name}) on cuda:0 over gloo ({ranks[0][name]['route']}): "
          f"{len(hist)} steps, {ranks[0][name]['seconds']:.1f} s command time on {smi}; median "
          f"step {batch_t * 1e3:.1f} ms = {1 / batch_t:.3f} steps/s = "
          f"{TRAIN_BATCH / batch_t:.2f} images/s (host clock between steps, rank 0); loss per "
          f"step {[round(v, 4) for v in losses]}", flush=True)
    per = TRAIN_BATCH // data_groups
    epochs = len(hist) // 2
    want = {"aspp_depthwise3x3_multi": per * len(hist) + val_frames // data_groups * epochs,
            "depthwise3x3_dilated": 3 * per * len(hist)}
    for r, res in enumerate(ranks):
        res = res[name]
        data_t = np.median([h["data_time"] for h in res["history"]])
        print(f"  rank {r} (band {r % SPATIAL_TRAIN_SHARDS} of data group "
              f"{r // SPATIAL_TRAIN_SHARDS}): median host wait for data {data_t * 1e3:.1f} ms a "
              f"step; peak memory allocated {res['peak_gib']:.2f} GiB; launches "
              f"{launches_named(res['launches'])} (K4 {per} x {len(hist)} steps + "
              f"{val_frames // data_groups} x {epochs} validation frames, K3 {3 * per} x "
              f"{len(hist)}); checkpoints written {res['checkpoints']}", flush=True)
        if [h["loss"] for h in res["history"]] != losses:
            raise AssertionError(f"14(c) rank {r}: its losses differ from rank 0's")
        if launches_named(res["launches"]) != want:
            raise AssertionError(f"14(c) rank {r}: launches {res['launches']} != {want}")
        if bool(res["checkpoints"]) != (r == 0):
            raise AssertionError(f"14(c): rank {r} wrote checkpoints {res['checkpoints']}")
    if len(hist) != 4 or not (np.isfinite(losses).all()
                              and np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise AssertionError(f"14(c): {len(hist)} steps, the loss did not fall: {losses}")
    argv = dp_train_argv(RANKS / "refused", 1, "MODEL.SYNC_BN", "True",
                         "TRAIN.SPATIAL_SHARDS", "4", *device)
    t0 = time.perf_counter()
    refused = run_group("14d", where=RANKS, world=RANKS_WORLD, timeout=RANKS_TIMEOUT, argv=argv)
    words = f"TRAIN.SPATIAL_SHARDS=4 does not divide the world of {RANKS_WORLD} ranks"
    print(f"14(d) the same command with TRAIN.SPATIAL_SHARDS 4 on {RANKS_WORLD} ranks: every "
          f"rank raised ValueError({refused[0]['raised']}) in {time.perf_counter() - t0:.1f} s "
          "(the group's start included)", flush=True)
    if any(words not in (r["raised"] or "") for r in refused):
        raise AssertionError(f"14(d): not every rank refused: {refused}")


def spatial_ranks_phase(smi: str) -> None:
    """Phase 14: bands across ranks at full width, ranks on cuda:0 over gloo."""
    shutil.rmtree(RANKS, ignore_errors=True)
    RANKS.mkdir(parents=True)
    t0 = time.perf_counter()
    ranks_steps_phase(smi)
    ranks_train_phase(smi)
    print(f"phase 14 (bands across ranks) {time.perf_counter() - t0:.1f} s", flush=True)


RANK_TASKS = {"a": dp_rank_steps, "b": dp_rank_train, "14a": ranks_steps, "14c": dp_rank_train,
              "14d": ranks_refused}


def sweep(smi: str) -> None:
    """Launch choices at the main path's shapes, each checked against the
    default's output and timed with CUDA events on one set of inputs: K4's
    channel group and threads per block (bf16, d 12/24/36), the same two
    for K3, P1/"f32col" and "slab" per dilation, Q1's tile and channel
    block per site shape, K1's strip rows (5x2000x2000)."""
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
    sweep_q1(gen)
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


def sweep_q1(gen) -> None:
    """Q1's output tile, channel block and tiles a block at each site shape
    of ``Q1_SITES`` (int8 out with ReLU), each launch checked against the
    default plan's output and timed in a CUDA graph; the launch choices in
    ``ops/kernels/int8_conv.py`` come from it."""
    from vision_semantic_segmentation_tpu_torch.ops.kernels import int8_conv

    for (h, w, c), stride, d, _ in Q1_SITES:
        x = torch.randint(0, 128, (1, h, w, c), generator=gen, device="cuda", dtype=torch.int8)
        wt = torch.randint(-127, 128, (c, 3, 3, c // 32), generator=gen, device="cuda",
                           dtype=torch.int8)
        scale = torch.rand(c, generator=gen, device="cuda") * 1e-3
        shift = torch.rand(c, generator=gen, device="cuda") * 40 - 20
        args = (x, wt, scale, shift, stride, d, d, 32, torch.int8, True)
        want = int8_conv.int8_conv3x3(*args)
        default = graph_ms(lambda: int8_conv.int8_conv3x3(*args), 20)
        times = []
        for tile in ((8, 16), (4, 32), (16, 16), (8, 32), (4, 64)):
            for block_cols in (32, 64, 128):
                for tpb in (1, 2, 4, 8):
                    plan = int8_conv.q1_plan(1, h, w, c, c, 32, stride, d, d, 1, tile=tile,
                                             block_cols=block_cols, tiles_per_block=tpb)
                    if not torch.equal(int8_conv.launch_q1(*args, plan), want):
                        raise AssertionError(f"Q1 {(h, w, c)} {plan} differs from the default")
                    ms = graph_ms(lambda: int8_conv.launch_q1(*args, plan), 20)
                    times.append((ms, f"{plan.tile_h}x{plan.tile_w}/{plan.gb * plan.cols}/"
                                      f"{tpb} {plan.smem // 1024}K"))
        times.sort()
        print(f"  Q1 {(h, w, c)} stride {stride} dilation {d}: default {default:.4f} ms; "
              f"fastest (tile/channels/tiles a block, shared KB: ms; each equal to the "
              f"default's output): " + ", ".join(f"{n} {ms:.4f}" for ms, n in times[:12])
              + f"; slowest {times[-1][1]} {times[-1][0]:.4f}", flush=True)


def clock(t0: float, what: str) -> None:
    """Where the script's time goes: seconds since it started, per phase."""
    print(f"clock: {what} done at {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print("image libraries on this machine: " + ", ".join(
        f"{name} {'yes' if has_module(name) else 'no'}"
        for name in ("PIL", "cv2", "torchvision.io")), flush=True)
    t0 = time.perf_counter()
    seconds = K.build_all()
    print(f"kernel build {time.perf_counter() - t0:.1f} s {seconds}", flush=True)
    clock(start, "phase 1 (set-up and kernel build)")
    for k in K.kernels():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}", flush=True)
    if "--sweep" in sys.argv[1:]:
        sweep(smi)
        return
    if "--training" in sys.argv[1:]:
        training_phase(smi)
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
    clock(start, "phase 2 (kernels against their plain versions)")
    pipeline, frames = main_path(entries, smi)
    clock(start, "phase 3 (main path)")
    online_phase(pipeline, frames, smi)
    planar_phase(pipeline, smi)
    clock(start, "phase 4 (online and planar)")
    cli_phase(pipeline, frames, smi)
    clock(start, "phase 5 (command line)")

    args = [frames[k][1] for k in ("image", "pcd", "valid", "position", "quaternion")]
    grid = pipeline.init_grid()
    where_time_goes("one frame (main path, inputs on the card)", lambda: pipeline.step(grid, *args))
    bus = TopicBus()
    FusedOnlineNode(online_cfg(), bus, state_dict=pipeline.model.state_dict(), device="cuda")
    feed = make_online_feed(seed=300)[:3]
    publish_feed(bus, feed[:2])  # both cameras once
    where_time_goes("one online frame (FusedOnlineNode, frame and cloud from the host)",
                    lambda: publish_feed(bus, feed[2:]))
    bus = TopicBus()
    cfg = planar_cfg()
    predictor = SemanticSegmentation(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK,
                                     state_dict=pipeline.model.state_dict(),
                                     compute_dtype=torch.bfloat16, device="cuda")
    SegmentationNode(cfg, bus, predictor=predictor, publish_hulls=True)
    MappingNode(cfg, bus, device="cuda")
    bus.publish("/estimated_plane", list(PLANE), stamp=0.5)
    feed = make_planar_feed(seed=500)[:3]

    def planar_frames(frames):
        for f in frames:
            bus.publish("/current_pose", f["pose"], stamp=f["stamp"])
            bus.publish(f"/{f['camera']}/image_raw", f["image"], stamp=f["stamp"],
                        frame_id=f["camera"])

    planar_frames(feed[:2])  # both cameras once
    where_time_goes("one planar two-node frame with hulls (frame from the host)",
                    lambda: planar_frames(feed[2:]))
    cli_host_steps(pipeline, smi)
    weights = CLI / "weights.pth"
    where_time_goes("CLI pipeline --fused over the .bag (the whole call)", lambda: cli_main([
        "pipeline", "--cfg", overlay("fused_profiled", weights), "--bag",
        str(CLI / "main_window.bag"), "--fused"]), top=6)
    where_time_goes("CLI replay of the pre-segmented .npz (the whole call)", lambda: cli_main([
        "replay", "--cfg", overlay("replay_profiled", weights), "--input-dir",
        str(CLI / "replay_all")]), top=6)
    clock(start, "phase 6 (where the time goes)")
    host_phase(pipeline, frames, smi)
    clock(start, "phase 8 (host-side commands)")
    entries.append(int8_phase(pipeline, smi))
    clock(start, "phase 9 (a)-(c), (e) (int8 serving)")
    del pipeline, frames
    torch.cuda.empty_cache()
    golden = training_phase(smi)
    clock(start, "phase 7 (training)")
    int8_golden(*golden, smi)
    clock(start, "phase 9(d) (int8 golden scene)")
    k3 = serving_tools_phase(smi)
    entries = [k3 if e["name"] == k3["name"] else e for e in entries]
    clock(start, "phase 10 (serving tools)")
    parallel_phase(smi)
    clock(start, "phase 11 (parallel replay)")
    data_parallel_phase(smi)
    clock(start, "phase 12 (data-parallel training)")
    spatial_phase(smi)
    clock(start, "phase 13 (spatial sharding)")
    spatial_ranks_phase(smi)
    clock(start, "phase 14 (bands across ranks)")

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if "--rank-worker" in sys.argv:
        rank_worker(sys.argv[sys.argv.index("--rank-worker") + 1])
    else:
        main()
