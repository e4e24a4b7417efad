"""Command line of the PyTorch/CUDA port.

Port of ``vision_semantic_segmentation_tpu/__main__.py`` (the reference's
roslaunch files and scripts, ref README.md:113,127), with its commands'
flags:

    python -m vision_semantic_segmentation_tpu_torch replay   --cfg exp.yaml [--input-dir d]
                                                              [--resume-grid g] [--save-grid g]
                                                              [--frame-parallel]
    python -m vision_semantic_segmentation_tpu_torch pipeline --cfg exp.yaml --bag seq.{npz,hkl,pkl,bag}
                                                              [--fused [--confidence]]
                                                              [--rate R [--decode-ahead]]
    python -m vision_semantic_segmentation_tpu_torch export   input.{hkl,pkl,bag} [--out f.npz]
    python -m vision_semantic_segmentation_tpu_torch eval     --maps dir --gt dir
    python -m vision_semantic_segmentation_tpu_torch train    --cfg train.yaml [KEY VALUE ...]
    torchrun --nproc-per-node N -m vision_semantic_segmentation_tpu_torch train --distributed
                                                              --cfg train.yaml [KEY VALUE ...]
    python -m vision_semantic_segmentation_tpu_torch convert  weights.pth|train_dir [--out f.npz]
    python -m vision_semantic_segmentation_tpu_torch profile  --cfg exp.yaml [--window T] [--json f]
    python -m vision_semantic_segmentation_tpu_torch video    --cfg demo.yaml --video in.mp4
    python -m vision_semantic_segmentation_tpu_torch quantize --cfg exp.yaml --calib seq.{npz,bag}
                                                              [--frames 8] [--out qpack.npz]
    python -m vision_semantic_segmentation_tpu_torch compile  --cfg exp.yaml [--out runner.vsstexp]
                                                              [--height H --width W --window T]
    python -m vision_semantic_segmentation_tpu_torch autotune --cfg exp.yaml [--out tuned.yaml]
                                                              [--update-windows 0,600]
    python -m vision_semantic_segmentation_tpu_torch autotune --serving --cfg exp.yaml
                                                              [--backbones ..] [--strides ..]
                                                              [--scales ..] [--no-quality]

Every command that runs the system takes ``--device {cuda,cpu}`` (default
``cuda``; without a card ``cuda`` raises, nothing falls back to the CPU).
On the card, replay runs K2 per frame and K1 per map (``--frame-parallel``
fuses frames data-parallel over every local card, one partial grid each;
``MAPPING.GRID_SHARDS`` row-shards the grid over that many cards, K2 per
frame per band); ``pipeline`` adds K4
per segmented frame (a planar ``MAPPING.DEPTH_METHOD`` runs no K2).  The
two-node dataflow runs the network in ``MODEL.COMPUTE_DTYPE`` (bf16 by
default); every fused path (``--fused``, with or without ``--rate``) runs
it in the fused pipeline's bf16, as the JAX package does.  ``train`` trains
on one device (``train/trainer.py``), or with ``--distributed`` as one rank
of ``torchrun``'s process group, one rank a card, data-parallel over the
global batch ``TRAIN.BATCH_SIZE``; ASPP's depthwise convs run K4 forward
and K3 dgrad there.  ``profile`` times the fused pipeline's stages
(``runtime/profiling.py``: K4 in its forward stage, K4 and K2 in its e2e
stage), ``video`` segments a video file (K4 a frame), ``convert``
writes a ``.pth`` as the JAX package's ``.npz`` (host only) and
``quantize`` calibrates and writes an int8 qpack, which the two-node
dataflow serves when ``VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.QPACK`` names
it (Q1 on the backbone's 3x3 sites; the fused paths build from the float
weights and ignore it, as the JAX package's do).  ``compile`` writes the
fused frame step exported by ``torch.export`` (``runtime/export.py``; the
weights stay out of the artifact and are supplied at load, the kernels are
custom ops in it); ``autotune`` times the grid update's
``UPDATE_WINDOW`` candidates and writes the winner as a YAML overlay
(``runtime/tuning.py``); ``autotune --serving`` sweeps operating points
for frames/s and golden-scene mIoU (``runtime/serving_pareto.py``).
``MODEL.SPATIAL_SHARDS`` bands the two-node dataflow's frames over the
device's local cards (``inference/predictor.py``) and
``TRAIN.SPATIAL_SHARDS`` the training crops (``train/trainer.py``); with
fewer cards than shards each raises the JAX package's ``ValueError``.

``main(argv)`` returns the command's result: replay the rendered maps,
``pipeline`` a :class:`FusedRun` (``--fused``), the
:class:`~.runtime.async_bus.PlaybackReport` (``--rate``) or the
:class:`~.runtime.node.MappingNode` (the two-node dataflow), ``export`` the
frames written, ``eval`` the scores, ``train`` the
:class:`~.train.trainer.Trainer`, ``convert`` the ``.npz`` path,
``profile`` the result dict, ``video`` the output video path,
``quantize`` the qpack, ``compile`` the artifact's path, ``autotune`` the
tuner's result and ``autotune --serving`` the Pareto result.
"""
from __future__ import annotations

import argparse
import dataclasses
import os.path as osp
import time

import numpy as np
import torch


def _load_app_cfg(config_files):
    """Merge one or more YAML files over the defaults, in order."""
    from .config import get_cfg_defaults

    cfg = get_cfg_defaults()
    for path in config_files or []:
        cfg.merge_from_file(path)
    return cfg


def cmd_replay(args):
    from .runtime.replay import MappingReplay

    cfg = _load_app_cfg(args.cfg)
    if args.input_dir:
        cfg.MAPPING.INPUT_DIR = args.input_dir
    return MappingReplay(cfg, device=args.device, frame_parallel=args.frame_parallel).replay_dir(
        resume_grid=args.resume_grid or None, save_grid=args.save_grid or None)


def _read_frames(path: str):
    """Recorded frames of a ``.bag`` (decoded on a worker thread as they
    are consumed), ``.npz``, ``.hkl`` or ``.pkl``."""
    from .runtime.io import load_frames, load_reference_dump

    if path.endswith(".bag"):
        from .runtime.bag_adapter import stream_bag_frames

        return stream_bag_frames(path)
    if path.endswith(".npz"):
        return load_frames(path)
    return load_reference_dump(path)


def cmd_pipeline(args):
    """Run both nodes in-process over a recorded sequence (camera1_mapping).

    ``--fused`` runs the fused frame pipeline over windows of 8 frames
    instead of the two-node dataflow; ``--rate`` plays a ``.bag`` on its own
    timeline through nodes on executor threads, overload surfacing as
    dropped frames (with ``--fused``: one FusedOnlineNode; with
    ``--decode-ahead``: the bag decoded on a worker thread).
    """
    from .mapping.engine import SemanticMappingEngine
    from .runtime.bus import TopicBus
    from .runtime.node import MappingNode, SegmentationNode
    from .utils.ros_compat import TransformTree

    cfg = _load_app_cfg(args.cfg)
    if args.fused and not args.rate:
        return _fused_pipeline(cfg, args.bag, confidence=args.confidence, device=args.device)
    if args.rate:
        if not args.bag.endswith(".bag"):
            raise SystemExit(
                "--rate needs a ROS .bag recording (its timeline drives the wall clock); use "
                "`export` to convert, or replay .npz sequences offline without --rate")
        from .runtime.async_bus import run_online

        report = run_online(cfg, args.bag, rate=float(args.rate), fused=args.fused,
                            decode_ahead=args.decode_ahead, device=args.device)
        print(f"online replay @ {report.rate}x: {report.published} msgs in "
              f"{report.wall_duration_s:.1f}s (bag {report.bag_duration_s:.1f}s), "
              f"fused {report.fused_frames}, dropped {report.dropped_total} "
              f"({report.drops or 'none'}) + {report.dropped_frames} unsynced, "
              f"max lag {report.max_lag_s * 1e3:.0f} ms")
        return report
    bus = TopicBus()
    SegmentationNode(cfg, bus, device=args.device)
    node = MappingNode(cfg, bus, engine=SemanticMappingEngine(cfg, device=args.device),
                       tf_tree=TransformTree())
    if args.bag.endswith(".bag"):
        from .runtime.bag_adapter import play_bag

        # the node folds /tf bus messages into its tree; passing the tree
        # here as well would apply every transform twice
        play_bag(args.bag, bus)
    else:
        frames = _read_frames(args.bag)
        # clouds go on the topic MAPPING.DEPTH_METHOD selects (a planar
        # node subscribes none)
        pcd_topic = node.pcd_topic or "/reduced_map"
        for f in frames:
            bus.publish(pcd_topic, f.pcd, stamp=f.stamp, frame_id=f.pcd_frame_id)
            bus.publish("/current_pose", (f.position, f.quaternion), stamp=f.stamp)
            bus.publish(f"/{f.camera}/image_raw", f.semantic_image, stamp=f.stamp,
                        frame_id=f.camera)
    if node.grid is not None and node.finalized_map is None:
        node.finalize()
    return node


@dataclasses.dataclass
class FusedRun:
    """What ``pipeline --fused`` made: the grid, the rendered map, the
    frames fused, and the host-clock seconds from the first decoded frame
    to the saved map."""

    grid: torch.Tensor
    color_map: np.ndarray
    frames: int
    seconds: float


def _fused_pipeline(cfg, bag_path: str, confidence: bool = False, device="cuda") -> FusedRun:
    """Raw frames -> FusedFramePipeline windows -> finalized map (+ eval).

    Reuses MappingReplay's chunking and staging with the fused pipeline
    running each staged window.  Distortion follows
    ``VISION_SEM_SEG.UNDISTORT``: True means raw camera frames, handled on
    the projected points; False means rectified frames and a pinhole
    projection.  ``confidence`` weights each point's evidence by the
    network's softmax confidence at its pixel.  The network runs in the
    pipeline's bf16, whatever ``MODEL.COMPUTE_DTYPE`` says, as in the JAX
    package's CLI.
    """
    from .mapping.engine import SemanticMappingEngine
    from .models.convert import load_weights
    from .runtime.pipeline import FusedFramePipeline
    from .runtime.replay import MappingReplay

    net_cfg = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    if not net_cfg.MODEL.WEIGHT:
        raise ValueError("VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.WEIGHT is empty")
    engine = SemanticMappingEngine(cfg, device=device)
    undistort = bool(cfg.VISION_SEM_SEG.get("UNDISTORT", True))
    pipeline = FusedFramePipeline(
        cfg, load_weights(net_cfg.MODEL.WEIGHT), engine=engine,
        distortion="points" if undistort else "none",
        confidence_weighting=confidence, device=device)
    replay = MappingReplay(cfg, engine=engine)

    clock = {}

    def timed(frames):
        for f in frames:
            clock.setdefault("first_frame", time.perf_counter())
            yield f

    grid = pipeline.init_grid()
    n_fused = 0
    for chunk in replay._chunk_frames(timed(_read_frames(bag_path)), window=8):
        n_fused += len(chunk)
        grid = pipeline.run_window(grid, replay._stage(chunk, min_len=1).wait(),
                                   camera=chunk[0].camera, pcd_frame_id=chunk[0].pcd_frame_id)
    if n_fused == 0:
        raise SystemExit(f"no frames in {bag_path}")
    color_map = replay.finalize(grid, name="fused")
    return FusedRun(grid, color_map, n_fused, time.perf_counter() - clock["first_frame"])


def cmd_train(args):
    """Train the segmentation network (JAX ``cmd_train``, ref train.py:163)."""
    from .config import get_train_cfg_defaults, resolve_output_dir
    from .parallel.distributed import ensure_distributed
    from .train.trainer import train
    from .utils.logger import setup_logger

    cfg = get_train_cfg_defaults()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    output_dir = resolve_output_dir(cfg.OUTPUT_DIR, cfg.TASK_NAME)
    # rank 0 alone logs
    main_rank = not args.distributed or ensure_distributed(args.device).rank == 0
    logger = setup_logger("train", output_dir) if main_rank else None
    return train(cfg, output_dir=output_dir, logger=logger, device=args.device,
                 distributed=args.distributed)


def cmd_eval(args):
    from .evaluation.map_eval import MapEvaluator

    return MapEvaluator(ground_truth_dir=args.gt).full_test(
        dir_path=args.maps, latex_mode=args.latex, verbose=True)


def cmd_export(args):
    """Carry a recorded input (``.hkl``, ``.pkl`` or ``.bag``) over to the
    native ``.npz`` replay format."""
    from .runtime.io import load_reference_dump, save_frames

    src = args.input
    if src.endswith(".bag"):
        from .runtime.bag_adapter import bag_to_frames

        frames = bag_to_frames(src, image_topic=args.image_topic, pcd_topic=args.pcd_topic,
                               pose_topic=args.pose_topic)
    else:
        frames = load_reference_dump(src)
    out = args.out or osp.splitext(src)[0] + ".npz"
    save_frames(frames, out)
    print(f"wrote {out} ({len(frames)} frames)")
    return frames


def cmd_convert(args):
    from .models.convert import convert_pth_to_npz

    out = convert_pth_to_npz(args.pth, args.out)
    print(f"wrote {out}")
    return out


def cmd_profile(args):
    """Stage-level timing of the fused pipeline at this config's shapes on
    this device: NULL-corrected forward / fusion / e2e ms per frame and
    frames/s (``runtime/profiling.py``; the counterpart of the reference's
    model_timer, ref core/utils/benchmark.py:17-25)."""
    import json

    from .runtime.profiling import format_report, profile_stages

    cfg = _load_app_cfg(args.cfg)
    result = profile_stages(
        cfg,
        image_hw=(args.height, args.width),
        window=args.window,
        n_windows=args.windows,
        repeats=args.repeats,
        camera=args.camera,
        distortion=args.distortion,
        confidence_weighting=args.confidence,
        log=print,
        device=args.device,
    )
    print(format_report(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.json}")
    return result


def cmd_video(args):
    from .config import get_demo_cfg_defaults, resolve_output_dir
    from .runtime.video import generate_video

    cfg = get_demo_cfg_defaults()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    output_dir = resolve_output_dir(cfg.OUTPUT_DIR)
    return generate_video(cfg, args.video, output_dir, output_name=cfg.OUTPUT_NAME,
                          device=args.device)


def cmd_quantize(args):
    """Calibrate and write an int8 PTQ pack for the serving path (JAX
    ``cmd_quantize``).

    Reads calibration frames from a recorded sequence (.npz or ROS .bag),
    applies the node's preprocessing (the ``IMAGE_SCALE`` area resize, as
    the predictor sees frames when serving), calibrates activation scales,
    quantizes the backbone and writes the qpack (``models/quant.py``).
    Serve it by setting ``VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.QPACK`` to the
    output path.
    """
    from .inference.predictor import SemanticSegmentation
    from .models.quant import save_qpack
    from .ops.resize import resize_area

    cfg = _load_app_cfg(args.cfg)
    if args.calib.endswith(".bag"):
        from .runtime.bag_adapter import bag_to_frames

        frames = bag_to_frames(args.calib)
    else:
        from .runtime.io import load_frames

        frames = load_frames(args.calib)
    step = max(1, len(frames) // max(1, args.frames))
    images = [f.semantic_image for f in frames[::step][: args.frames]]
    predictor = SemanticSegmentation(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, device=args.device)
    scale = float(cfg.VISION_SEM_SEG.IMAGE_SCALE)
    if scale < 1.0:  # on the predictor's device, as the node resizes
        images = [resize_area(torch.as_tensor(np.asarray(img), device=predictor.device),
                              (int(img.shape[0] * scale), int(img.shape[1] * scale)))
                  .cpu().numpy() for img in images]
    predictor.quantize(images)
    save_qpack(predictor.qpack, args.out)
    print(f"wrote {args.out} ({len(images)} calibration frames)")
    return predictor.qpack


def cmd_compile(args):
    """Export the fused frame step to a serving artifact (JAX ``cmd_compile``).

    ``torch.export`` traces the camera + LiDAR step at the given frame size
    (``runtime/export.py``); loading it back builds no pipeline and traces
    nothing.  The artifact pins camera, frame size, window length and grid
    geometry; the weights stay outside and are supplied at load time.
    """
    from .mapping.engine import SemanticMappingEngine
    from .models.convert import load_weights
    from .runtime.export import export_sequence_runner
    from .runtime.pipeline import FusedFramePipeline

    cfg = _load_app_cfg(args.cfg)
    weight = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.WEIGHT
    engine = SemanticMappingEngine(cfg, device=args.device)
    pipeline = FusedFramePipeline(cfg, load_weights(weight) if weight else None, engine=engine,
                                  distortion="points", device=args.device)
    out = export_sequence_runner(pipeline, args.out, image_hw=(args.height, args.width),
                                 window=args.window, camera=args.camera)
    print(f"wrote {out}")
    return out


def cmd_autotune_serving(args):
    """Serving operating points (``runtime/serving_pareto.py``): every
    backbone x OUTPUT_STRIDE x IMAGE_SCALE x UPSAMPLE_PRED point timed
    through the fused pipeline, then (unless --no-quality) scored for
    golden-scene mIoU with a network trained for the point.  Writes the
    recommended point as a YAML overlay and (with --json) the sweep.  A
    point whose quality fails is reported and the sweep goes on, marked
    ``partial`` (in the JSON and the overlay's first line)."""
    import traceback

    from .runtime.serving_pareto import (
        SceneArtifacts,
        default_points,
        pareto,
        score_quality,
        serving_overlay_yaml,
        sweep_fps,
        write_json,
    )

    cfg = _load_app_cfg(args.cfg)
    kwargs = {}
    if args.backbones:
        kwargs["backbones"] = [b for b in args.backbones.split(",") if b]
    if args.strides:
        kwargs["strides"] = [int(v) for v in args.strides.split(",") if v]
    if args.scales:
        kwargs["scales"] = [float(v) for v in args.scales.split(",") if v]
    if args.upsample != "both":
        kwargs["upsample"] = (args.upsample == "on",)
    points = default_points(**kwargs)
    print(f"serving sweep: {len(points)} operating points")

    fps_rows = sweep_fps(cfg, points, image_hw=(args.height, args.width), window=args.window,
                         n_windows=args.windows, repeats=args.repeats, camera=args.camera,
                         log=print, device=args.device)
    quality_rows, missing = [], []
    if not args.no_quality:
        scene_dir = args.scene_dir or osp.join(
            osp.dirname(osp.abspath(args.out)) or ".", "serving_scene")
        scene = SceneArtifacts(scene_dir, log=print)
        for point in points:
            try:
                quality_rows.append(score_quality(
                    scene, point, cfg=cfg, train_steps=args.train_steps,
                    train_batch=args.train_batch or None, log=print, device=args.device))
            except Exception:  # one failed point must not end the sweep: it is marked
                print(f"quality point {point} failed (the sweep is partial):\n"
                      + traceback.format_exc())
                missing.append(point)
    result = pareto(fps_rows, quality_rows, quality_budget=args.budget,
                    missing_quality_points=missing)
    if result["recommended"] is not None:
        r = result["recommended"]
        print(f"recommended: {r['backbone']} os{r['output_stride']} scale={r['image_scale']} "
              f"upsample={r['upsample_pred']} -> {r['fps']} fps at miou {r.get('miou')} "
              f"(anchor {result['anchor_miou']})"
              + (f"; PARTIAL: {len(missing)} point(s) unscored" if missing else ""))
        with open(args.out, "w") as f:
            f.write(serving_overlay_yaml(r, result))
        print(f"wrote {args.out}")
    elif fps_rows and args.no_quality:
        fastest = max(fps_rows, key=lambda x: x["fps"])
        print("fps-only sweep (no quality scores): fastest point "
              f"{fastest['backbone']} os{fastest['output_stride']} "
              f"scale={fastest['image_scale']} upsample={fastest['upsample_pred']} "
              f"-> {fastest['fps']} fps; NOT writing an overlay without a quality budget check")
    if args.json:
        print(f"wrote {write_json(result, args.json)}")
    return result


def cmd_autotune(args):
    """Time the grid update's window candidates at this config's shapes on
    this device and write a YAML overlay naming the winner
    (``runtime/tuning.py``):
    ``autotune --cfg exp.yaml --out tuned.yaml``, then ``--cfg exp.yaml
    --cfg tuned.yaml`` (repeated --cfg merges in order)."""
    from .runtime.tuning import tune, write_overlay

    if args.serving:
        return cmd_autotune_serving(args)
    cfg = _load_app_cfg(args.cfg)
    update_windows = ([int(v) for v in args.update_windows.split(",") if v != ""]
                      if args.update_windows else None)
    result = tune(cfg, image_hw=(args.height, args.width), window=args.window,
                  n_windows=args.windows, repeats=args.repeats,
                  update_windows=update_windows, camera=args.camera,
                  distortion=args.distortion, log=print, device=args.device)
    best = result["best"]
    print(f"best: update_window={best['update_window']} -> {best['fps']} fps "
          f"on {result['device_kind']}")
    print(f"wrote {write_overlay(result, args.out)}")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(prog="vision_semantic_segmentation_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_cfg_and_device(p):
        p.add_argument("--cfg", action="append", default=[], metavar="FILE",
                       help="experiment YAML; repeat to merge overlays in order")
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the system runs (default cuda; raises without a card)")

    p = sub.add_parser("replay", help="offline deterministic mapping replay")
    add_cfg_and_device(p)
    p.add_argument("--input-dir", default="")
    p.add_argument("--frame-parallel", action="store_true",
                   help="fuse frames data-parallel across all devices (one psum)")
    p.add_argument("--resume-grid", default="", metavar="NPZ",
                   help="seed the evidence grid from a checkpoint (threads ONE grid "
                        "through all input files -> a single combined map)")
    p.add_argument("--save-grid", default="", metavar="NPZ",
                   help="checkpoint the evidence grid after the last input file")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("pipeline", help="run seg+mapping nodes over a recorded sequence")
    add_cfg_and_device(p)
    p.add_argument("--bag", required=True, help=".npz, .hkl or .pkl sequence, or ROS .bag file")
    p.add_argument("--fused", action="store_true",
                   help="fused frame pipeline over windows of 8 frames; with --rate: one "
                        "FusedOnlineNode instead of the two-node topology")
    p.add_argument("--rate", type=float, default=0.0, metavar="R",
                   help="online mode: play the bag at R x real time through concurrently "
                        "executing nodes; overload drops frames (reported)")
    p.add_argument("--confidence", action="store_true",
                   help="with --fused: weight each point's evidence by the network's softmax "
                        "confidence at its pixel")
    p.add_argument("--decode-ahead", action="store_true", dest="decode_ahead",
                   help="with --rate: decode the bag (JPEG, PointCloud2) on a worker thread "
                        "overlapping node compute instead of on the pacing thread (the "
                        "production feed for compressed bags on a small host)")
    p.set_defaults(fn=cmd_pipeline)

    p = sub.add_parser("train", help="train the segmentation network")
    p.add_argument("--cfg", default="", metavar="FILE")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the network trains: cuda (with --distributed the rank's "
                        "cuda:LOCAL_RANK) or cpu (default cuda; raises without a card)")
    p.add_argument("--distributed", action="store_true",
                   help="train data-parallel as one rank of torchrun's process group "
                        "(nccl on cards, gloo on the CPU); raises without one")
    p.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="score generated maps against ground truth")
    p.add_argument("--maps", default="./global_maps")
    p.add_argument("--gt", default="./ground_truth")
    p.add_argument("--latex", action="store_true")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("convert", help="convert a torch .pth checkpoint to .npz")
    p.add_argument("pth")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("export", help="convert a recorded input (.hkl/.pkl/.bag) to .npz")
    p.add_argument("input")
    p.add_argument("--out", default=None)
    p.add_argument("--image-topic", default="/camera1/image_raw")
    p.add_argument("--pcd-topic", default="/reduced_map")
    p.add_argument("--pose-topic", default="/current_pose")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("profile", help="stage-level timing (forward/fusion/e2e) of the fused "
                                       "pipeline at this config's shapes on this device")
    add_cfg_and_device(p)
    p.add_argument("--camera", default="camera1")
    p.add_argument("--height", type=int, default=1440)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--window", type=int, default=16, help="frames per timed window")
    p.add_argument("--windows", type=int, default=2,
                   help="distinct timed windows (fresh data each)")
    p.add_argument("--repeats", type=int, default=3, help="best-of repeats")
    p.add_argument("--distortion", default="auto", choices=["auto", "none", "points"])
    p.add_argument("--confidence", action="store_true",
                   help="profile the confidence-weighted fusion path")
    p.add_argument("--json", default="", metavar="FILE",
                   help="also write the result dict as JSON")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("video", help="segmentation overlay video demo")
    p.add_argument("--cfg", default="", metavar="FILE")
    p.add_argument("--video", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the network runs (default cuda; raises without a card)")
    p.set_defaults(fn=cmd_video)

    p = sub.add_parser("quantize", help="calibrate + export an int8 PTQ pack (serving)")
    add_cfg_and_device(p)
    p.add_argument("--calib", required=True,
                   help="recorded sequence (.npz or .bag) to calibrate on")
    p.add_argument("--frames", type=int, default=8,
                   help="number of calibration frames sampled from it")
    p.add_argument("--out", default="qpack.npz")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("compile", help="export the fused pipeline's frame step to a serving "
                                       "artifact")
    add_cfg_and_device(p)
    p.add_argument("--out", default="runner.vsstexp")
    p.add_argument("--camera", default="camera1")
    p.add_argument("--height", type=int, default=1440)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--window", type=int, default=16)
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser("autotune", help="measure grid-update windows at this config's shapes; "
                                        "write a YAML overlay selecting the winner")
    add_cfg_and_device(p)
    p.add_argument("--out", default="tuned.yaml")
    p.add_argument("--camera", default="camera1")
    p.add_argument("--height", type=int, default=1440)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--window", type=int, default=16, help="frames per timed window")
    p.add_argument("--windows", type=int, default=2,
                   help="distinct timed windows (fresh data each)")
    p.add_argument("--repeats", type=int, default=3, help="best-of repeats")
    p.add_argument("--update-windows", default="",
                   help="comma list of UPDATE_WINDOW cell sizes to sweep (0 = dense); "
                        "default 0 and ceil(2.2 * PCD.RANGE_MAX / RESOLUTION)")
    p.add_argument("--distortion", default="auto", choices=["auto", "none", "points"])
    p.add_argument("--serving", action="store_true",
                   help="sweep serving operating points instead of grid-update windows: "
                        "backbone x OUTPUT_STRIDE x IMAGE_SCALE x UPSAMPLE_PRED, each timed "
                        "through the fused pipeline and scored for golden-scene map mIoU; "
                        "writes the Pareto frontier and a recommended overlay")
    p.add_argument("--backbones", default="",
                   help="[serving] comma list (default resnext50_32x4d,resnet50)")
    p.add_argument("--strides", default="",
                   help="[serving] comma list of OUTPUT_STRIDE (default 8,16)")
    p.add_argument("--scales", default="",
                   help="[serving] comma list of IMAGE_SCALE (default 1.0,0.5,0.355)")
    p.add_argument("--upsample", default="both", choices=["both", "on", "off"],
                   help="[serving] UPSAMPLE_PRED values to sweep")
    p.add_argument("--no-quality", action="store_true",
                   help="[serving] fps sweep only (no golden-scene training or scoring)")
    p.add_argument("--scene-dir", default="",
                   help="[serving] directory for golden-scene artifacts (reused across runs; "
                        "default <out dir>/serving_scene)")
    p.add_argument("--train-steps", type=int, default=400,
                   help="[serving] most segmenter train steps per point")
    p.add_argument("--train-batch", type=int, default=0,
                   help="[serving] segmenter train mini-batch (0 = all 8 frames)")
    p.add_argument("--budget", type=float, default=0.95,
                   help="[serving] the recommended point keeps this fraction of the headline "
                        "point's golden mIoU")
    p.add_argument("--json", default="", help="[serving] also dump the full sweep as JSON")
    p.set_defaults(fn=cmd_autotune)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
