"""Serving operating-point sweep: frames/s x golden-map quality Pareto.

Port of ``vision_semantic_segmentation_tpu/runtime/serving_pareto.py``
(``autotune --serving``).  The reference's own deployment knobs are
``VISION_SEM_SEG.IMAGE_SCALE`` (ref base_cfg.py:91) and the backbone and
output stride (ref models/backbone/build.py:12-16); this module measures
that space on both axes:

* **frames/s**: every operating point (backbone x OUTPUT_STRIDE x
  IMAGE_SCALE x UPSAMPLE_PRED) timed through the fused pipeline on the
  device at the camera's frame size (``tuning.time_fused_runner``; timing
  does not depend on the weights, so they are seeded random);
* **quality**: golden-map mIoU per point: a DeepLabV3+ with the point's
  backbone and stride is trained at the point's input size on the
  synthetic exact-ground-truth scene (``evaluation/synthetic_scene.py``),
  the fused pipeline maps the scene at the point's serving config, and
  ``MapEvaluator`` scores the map (the unfused ``apply_filter`` +
  ``render_bev_map`` finalize, as the JAX module renders).

:func:`pareto` joins the two sweeps, marks the Pareto-efficient points and
recommends the fastest point within a quality budget of the headline point.

Two defects of the JAX module are not copied:

* its weight cache keys on the point alone, so weights trained under
  another recipe or by other code are reused; here the file name carries
  a digest of the recipe (``train_steps``, ``train_batch``, ``train_lr``,
  ``train_floor``, compute dtype) and of the sources training runs
  through (:func:`training_digest`);
* its partial frontier carries no mark; here a sweep whose quality is
  missing at any point is ``partial`` with ``missing_quality_points``, and
  its overlay says so in a first comment line.

The scene's ground truth is written as ``truth.npy``/``mask.npy``
(``write_truth_arrays``), which ``MapEvaluator`` reads without OpenCV.
"""
from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .tuning import _resolve_distortion, generate_windows, init_state_dict, time_fused_runner

# the headline operating point: quality budgets are relative to it
HEADLINE_POINT = {
    "backbone": "resnext50_32x4d",
    "output_stride": 8,
    "image_scale": 1.0,
    "upsample_pred": False,
}

# what training a point's network runs through, relative to the package
_TRAINING_SOURCES = ("evaluation/synthetic_scene.py", "models", "parallel", "train", "ops",
                     "csrc")


def default_points(
    backbones: Sequence[str] = ("resnext50_32x4d", "resnet50"),
    strides: Sequence[int] = (8, 16),
    scales: Sequence[float] = (1.0, 0.5, 0.355),
    upsample: Sequence[bool] = (False, True),
) -> List[Dict]:
    """The sweep grid.  0.355 ~= a 512x768 input."""
    pts = []
    for b in backbones:
        for s in strides:
            for sc in scales:
                for up in upsample:
                    pts.append({
                        "backbone": b,
                        "output_stride": int(s),
                        "image_scale": float(sc),
                        "upsample_pred": bool(up),
                    })
    return pts


def point_key(p: Dict) -> Tuple:
    return (
        p["backbone"], int(p["output_stride"]),
        round(float(p["image_scale"]), 4), bool(p["upsample_pred"]),
    )


def _point_cfg(cfg, point: Dict):
    pc = cfg.clone()
    pc.defrost()
    pc.VISION_SEM_SEG.IMAGE_SCALE = float(point["image_scale"])
    pc.VISION_SEM_SEG.UPSAMPLE_PRED = bool(point["upsample_pred"])
    net = pc.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = point["backbone"]
    net.MODEL.OUTPUT_STRIDE = int(point["output_stride"])
    return pc


def sweep_fps(
    cfg,
    points: Sequence[Dict],
    image_hw: Tuple[int, int] = (1440, 1920),
    window: int = 16,
    n_windows: int = 2,
    repeats: int = 3,
    camera: str = "camera1",
    log=None,
    windows=None,
    device: DeviceLike = "cuda",
) -> List[Dict]:
    """Time the fused pipeline at every operating point.

    One set of frame windows is made once on the device and reused across
    points (``windows`` injects one made by the caller).  The seeded random
    weights are cached per (backbone, stride) across scale and upsample
    variants.
    """
    from ..mapping.engine import SemanticMappingEngine
    from .pipeline import FusedFramePipeline

    dev = resolve_device(device)
    if windows is None:
        windows = generate_windows(cfg, image_hw, window, n_windows, device=dev)
    weights: Dict[Tuple, Dict[str, torch.Tensor]] = {}
    rows = []
    for point in points:
        pc = _point_cfg(cfg, point)
        net = pc.VISION_SEM_SEG.SEM_SEG_NETWORK
        wkey = (point["backbone"], int(point["output_stride"]))
        if wkey not in weights:
            weights[wkey] = init_state_dict(net, device=dev)
        engine = SemanticMappingEngine(pc, device=dev)
        dist = _resolve_distortion(pc, engine, camera, image_hw, "auto")
        pipeline = FusedFramePipeline(pc, weights[wkey], engine=engine, distortion=dist,
                                      device=dev)
        fps, warmup_s = time_fused_runner(pipeline, windows, window, camera, repeats)
        row = dict(point, fps=round(fps, 3), ms_per_frame=round(1000.0 / fps, 3),
                   warmup_s=round(warmup_s, 1))
        rows.append(row)
        if log:
            log(
                f"fps  {row['backbone']:<16} os{row['output_stride']} "
                f"scale={row['image_scale']:<5} up={int(row['upsample_pred'])} "
                f"{row['fps']:8.2f} fps ({row['ms_per_frame']:.1f} ms/frame, "
                f"warmup {row['warmup_s']:.0f}s)"
            )
    return rows


class SceneArtifacts:
    """The golden scene's frames and ground truth, rendered once per sweep.

    ``pose_stride`` thins the 90-pose lattice (every k-th pose); map
    coverage shrinks with it.
    """

    def __init__(self, root: str, pose_stride: int = 1, log=None):
        from ..evaluation.synthetic_scene import (
            make_point_map,
            make_poses,
            render_frame,
            write_truth_arrays,
        )
        from .io import FrameRecord

        os.makedirs(root, exist_ok=True)
        self.root = root
        self.gt_dir = osp.join(root, "ground_truth")
        os.makedirs(self.gt_dir, exist_ok=True)
        write_truth_arrays(self.gt_dir)
        if log:
            log("rendering golden scene frames (once per sweep)...")
        self.poses = make_poses()[:: max(1, int(pose_stride))]
        pcd = make_point_map()
        with ThreadPoolExecutor(8) as pool:
            rendered = list(pool.map(lambda pq: render_frame(*pq), self.poses))
        self.images = [img for img, _ in rendered]
        self.net_labels = [lab for _, lab in rendered]
        self.frames = [
            FrameRecord(pcd=pcd, pcd_frame_id="world", semantic_image=self.images[i],
                        position=self.poses[i][0], quaternion=self.poses[i][1],
                        camera="camera1", stamp=float(i))
            for i in range(len(self.poses))
        ]
        # 8 training frames spanning viewpoints and yaws, and 8 held-out views
        # next to them (the trainer's generalisation gate)
        stride = max(1, len(self.poses) // 8)
        self.train_idx = list(range(0, len(self.poses), stride))[:8]
        self.val_idx = [min(i + max(1, stride // 2), len(self.poses) - 1)
                        for i in self.train_idx]
        self._staged: Dict[Tuple, Tuple] = {}

    def staged_windows(self, bucket: int, window: int, device: DeviceLike = "cuda"):
        """Frame windows staged in device memory once, shared by every
        ``score_quality`` call (the frames do not depend on the point: each
        point's pipeline rescales on the device).  Returns ``(windows,
        tail_frames)``; the tail (``len(frames) % window``) stays on the host
        for per-frame steps."""
        from ..mapping.engine import pad_points

        dev = resolve_device(device)
        key = (int(bucket), int(window), str(dev))
        if key not in self._staged:
            n_full = len(self.frames) - len(self.frames) % window
            windows = []
            for i in range(0, n_full, window):
                chunk = self.frames[i : i + window]
                padded = [pad_points(np.asarray(f.pcd, np.float32), bucket) for f in chunk]
                stacked = {
                    "image": np.stack([f.semantic_image for f in chunk]),
                    "pcd": np.stack([p for p, _ in padded]),
                    "valid": np.stack([v for _, v in padded]),
                    "position": np.stack([np.asarray(f.position, np.float32) for f in chunk]),
                    "quaternion": np.stack([np.asarray(f.quaternion, np.float32)
                                            for f in chunk]),
                }
                windows.append({k: torch.from_numpy(v).to(dev) for k, v in stacked.items()})
            self._staged[key] = (windows, list(self.frames[n_full:]))
        return self._staged[key]


def training_digest() -> str:
    """sha1 over the sources a point's training runs through (this
    package's ``_TRAINING_SOURCES``), so a weight file trained by other code
    is not reused."""
    root = Path(__file__).resolve().parents[1]
    digest = hashlib.sha1()
    for rel in _TRAINING_SOURCES:
        path = root / rel
        files = [path] if path.is_file() else sorted(
            p for p in path.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
        for f in files:
            digest.update(str(f.relative_to(root)).encode())
            digest.update(f.read_bytes())
    return digest.hexdigest()


def weight_path_for(root: str, point: Dict, recipe: Dict) -> str:
    """The cache file of a point's trained weights: the point, then a digest
    of the training recipe and of :func:`training_digest`."""
    key = point_key(point)
    digest = hashlib.sha1(json.dumps(
        {"recipe": recipe, "sources": training_digest()}, sort_keys=True).encode()).hexdigest()
    name = f"seg_{key[0]}_os{key[1]}_s{key[2]}_{digest[:16]}.pth".replace("/", "_")
    return osp.join(root, name)


def score_quality(
    scene: SceneArtifacts,
    point: Dict,
    cfg=None,
    train_steps: int = 400,
    train_batch: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    map_window: int = 10,
    train_floor="default",
    train_lr: Optional[float] = None,
    log=None,
    device: DeviceLike = "cuda",
) -> Dict:
    """Golden-map quality at one operating point.

    Trains the point's network at the point's input size (CNNs are not
    scale-invariant), maps the scene with the fused pipeline at the point's
    full serving config in ``compute_dtype`` (the program the fps sweep
    times), renders with ``apply_filter`` + ``render_bev_map`` and scores
    with ``MapEvaluator``.  ``train_floor`` goes to ``train_segmenter``'s
    ``quality_floor`` ("default" keeps its (0.97, 0.85) floor; None skips
    it).  Trained weights are reused from ``scene.root`` only under the
    same recipe and sources (:func:`weight_path_for`).
    """
    from ..evaluation.map_eval import MapEvaluator
    from ..evaluation.synthetic_scene import (
        apply_scene_mapping_cfg,
        scaled_hw,
        scene_network_cfg,
        subsample_labels,
        train_segmenter,
    )
    from ..mapping.engine import SemanticMappingEngine
    from ..mapping.renderer import render_bev_map
    from ..models.convert import load_weights
    from ..ops.filters import apply_filter
    from ..ops.resize import resize_area
    from .pipeline import FusedFramePipeline

    dev = resolve_device(device)
    t0 = time.perf_counter()
    hw = scaled_hw(point["image_scale"])
    recipe = {"train_steps": int(train_steps), "train_batch": train_batch,
              "train_lr": train_lr, "train_floor": train_floor,
              "compute_dtype": str(compute_dtype)}
    weight_path = weight_path_for(scene.root, point, recipe)
    if not osp.exists(weight_path):
        # the network's input is the pipeline's area-resized frame at this scale
        def _prep(idx):
            if point["image_scale"] >= 1.0:
                return ([scene.images[i].astype(np.float32) for i in idx],
                        [scene.net_labels[i] for i in idx])
            return ([resize_area(torch.from_numpy(scene.images[i]).to(dev), hw).cpu().numpy()
                     .astype(np.float32) for i in idx],
                    [subsample_labels(scene.net_labels[i], hw) for i in idx])

        train_imgs, train_labels = _prep(scene.train_idx)
        val_imgs, val_labels = _prep(scene.val_idx)
        kw = {} if train_floor == "default" else {"quality_floor": train_floor}
        if train_lr is not None:
            kw["lr"] = float(train_lr)
        train_segmenter(train_imgs, train_labels, weight_path, backbone=point["backbone"],
                        output_stride=int(point["output_stride"]), max_steps=train_steps,
                        batch_size=train_batch, val_frames=val_imgs, val_labels=val_labels,
                        log=log, device=dev, **kw)
    train_s = time.perf_counter() - t0

    base = cfg if cfg is not None else scene_network_cfg()
    pc = _point_cfg(base, point)
    apply_scene_mapping_cfg(pc, image_scale=point["image_scale"],
                            upsample_pred=point["upsample_pred"])
    pc.VISION_SEM_SEG.SEM_SEG_NETWORK.MODEL.WEIGHT = weight_path
    engine = SemanticMappingEngine(pc, device=dev)
    pipeline = FusedFramePipeline(pc, load_weights(weight_path), engine=engine,
                                  distortion="none",  # the scene's frames are pinhole
                                  compute_dtype=compute_dtype, device=dev)
    grid = pipeline.init_grid()
    windows, tail = scene.staged_windows(engine.point_bucket, map_window, dev)
    for staged in windows:
        grid = pipeline.run_window(grid, staged, camera="camera1")
    for f in tail:
        grid, _ = pipeline.step(grid, f.semantic_image, f.pcd, np.ones(f.pcd.shape[1], bool),
                                f.position, f.quaternion, camera="camera1")
    color_map = render_bev_map(apply_filter(grid.permute(1, 2, 0)),
                               np.array(pc.LABEL_COLORS, np.uint8)).cpu().numpy()
    result = MapEvaluator(ground_truth_dir=scene.gt_dir).test_single_map(color_map,
                                                                         verbose=False)
    row = dict(
        point,
        miou=round(float(result["miou"]), 4),
        iou={k: round(float(v), 4) for k, v in result["iou"].items()},
        missing_rate=round(float(result["missing_rate"]), 4),
        train_s=round(train_s, 1),
    )
    if log:
        log(
            f"miou {row['backbone']:<16} os{row['output_stride']} "
            f"scale={row['image_scale']:<5} up={int(row['upsample_pred'])} "
            f"miou={row['miou']:.3f} iou={row['iou']} (train {row['train_s']:.0f}s)"
        )
    return row


def pareto(
    fps_rows: Sequence[Dict],
    quality_rows: Sequence[Dict],
    quality_budget: float = 0.95,
    missing_quality_points: Sequence[Dict] = (),
) -> Dict:
    """Join the sweeps, mark Pareto-efficient points, pick a recommendation.

    A point is Pareto-efficient if no other point is at least as fast and
    strictly better, or as good and strictly faster.  The recommendation is
    the fastest point whose mIoU is within ``quality_budget`` of the
    headline point's (of the best measured mIoU when the headline point was
    not swept).  ``missing_quality_points`` names points whose quality
    failed: the result is then ``partial``, and lists their keys.
    """
    quality_by_key = {point_key(r): r for r in quality_rows}
    rows = []
    for fr in fps_rows:
        qr = quality_by_key.get(point_key(fr))
        row = dict(fr)
        if qr is not None:
            row.update(miou=qr["miou"], iou=qr["iou"], missing_rate=qr["missing_rate"],
                       train_s=qr["train_s"])
        rows.append(row)
    scored = [r for r in rows if "miou" in r]
    for r in scored:
        r["pareto"] = not any(
            (o["fps"] >= r["fps"] and o["miou"] > r["miou"])
            or (o["fps"] > r["fps"] and o["miou"] >= r["miou"])
            for o in scored
        )
    anchor = quality_by_key.get(point_key(HEADLINE_POINT))
    anchor_miou = anchor["miou"] if anchor else max((r["miou"] for r in scored), default=None)
    recommended = None
    if scored and anchor_miou is not None:
        eligible = [r for r in scored if r["miou"] >= quality_budget * anchor_miou]
        if eligible:
            recommended = max(eligible, key=lambda r: r["fps"])
    missing = [list(point_key(p)) for p in missing_quality_points]
    return {
        "rows": rows,
        "anchor_miou": anchor_miou,
        "quality_budget": quality_budget,
        "recommended": recommended,
        "partial": bool(missing),
        "missing_quality_points": missing,
    }


def serving_overlay_yaml(point: Dict, result: Optional[Dict] = None) -> str:
    """A recommended operating point as a merge-ready YAML overlay; a
    partial sweep's overlay starts with a line that says so."""
    lines = []
    if result is not None and result.get("partial"):
        missing = result["missing_quality_points"]
        lines.append(
            f"# PARTIAL sweep: quality missing at {len(missing)} point(s) "
            f"{missing}; the frontier lacks them")
    if result is not None and result.get("recommended") is not None:
        r = result["recommended"]
        lines.append(
            f"# serving-pareto recommendation: {r['fps']} fps at miou "
            f"{r.get('miou')} (budget {result['quality_budget']} x anchor "
            f"{result['anchor_miou']})"
        )
    lines += [
        "VISION_SEM_SEG:",
        f"  IMAGE_SCALE: {float(point['image_scale'])}",
        f"  UPSAMPLE_PRED: {bool(point['upsample_pred'])}",
        "  SEM_SEG_NETWORK:",
        "    MODEL:",
        f"      BACKBONE: {point['backbone']}",
        f"      OUTPUT_STRIDE: {int(point['output_stride'])}",
    ]
    return "\n".join(lines) + "\n"


def write_json(obj, path: str) -> str:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
