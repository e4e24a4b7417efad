"""Synthetic benchmark scene: exact-ground-truth golden bag generator.

Port of ``vision_semantic_segmentation_tpu/evaluation/synthetic_scene.py``:
a synthetic urban scene (road / crosswalk / lane regions) with exact
geometric ground truth, camera frames ray-cast through the real camera-1
calibration and vehicle extrinsics, a cell-centre point map, and a real
DeepLabV3+ trained in-process to segment the scene's input colours
(:func:`train_segmenter`, through the port's train step), so map quality
can be scored on the card without downloaded weights.

Ground truth: :func:`write_ground_truth` writes the evaluator's
``bev-5cm-*.jpg`` layers (OpenCV, imported lazily, as the JAX package
does); :func:`write_truth_arrays` writes the ``truth.npy`` / ``mask.npy``
that ``evaluation/map_eval.py`` reads without OpenCV (the machine with the
card may have none).  All region edges are multiples of 0.4 m from the
boundary minimum, so they align with the 0.2 m grid cells and the 8-px JPEG
blocks of the 5 cm layers: the arrays equal what the evaluator decodes from
the JPEGs.

Deviations from the JAX module (ADVICE.md, both low): the quality floor of
:func:`train_segmenter` reads the confusion of the final weights through
the evaluation step (running statistics, no update), where the JAX package
re-ran full train steps and discarded their updates; and no loop variable
shadows the batch size that the held-out gate reads.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# Scene definition (map coords = world + PCD_ORIGIN_OFFSET, meters)
# --------------------------------------------------------------------------
RES = 0.2
BOUNDARY = [[100.0, 140.0], [800.0, 840.0]]
GRID_HW = (200, 200)

# scene class ids: 0 background, 1 road, 2 crosswalk, 3 lane, 4 sky
BG, ROAD, CROSS, LANE, SKY = 0, 1, 2, 3, 4
# distinct *input* colors the network learns to segment
INPUT_COLORS = np.array(
    [[60, 60, 60], [105, 105, 105], [200, 60, 60], [240, 240, 80], [70, 130, 180]],
    dtype=np.uint8,
)
# network class ids (mapillary-19) per scene class: cfg.LABELS=[2,1,8,10,3]
# maps network ids road=2, crosswalk=1, lane=8; background/sky to ids the
# mapping ignores (ref base_cfg.py:47-57)
NET_IDS = np.array([5, 2, 1, 8, 0], dtype=np.int32)

# full camera-1 calibration resolution (geometry/camera.py::camera_setup_1)
FULL_HW = (1440, 1920)


def scene_class(mx, my):
    """Evaluate the scene at map coords (vectorized)."""
    cls = np.full(np.shape(mx), BG, dtype=np.int32)
    road = (mx >= 104.0) & (mx < 136.0) & (my >= 804.0) & (my < 836.0)
    cls[road] = ROAD
    lane = road & (((my >= 812.4) & (my < 813.2)) | ((my >= 826.8) & (my < 827.6)))
    cls[lane] = LANE
    cross = (mx >= 112.0) & (mx < 117.6) & (my >= 808.0) & (my < 832.0)
    cls[cross] = CROSS
    return cls


def _truth_5cm() -> np.ndarray:
    """Scene classes at 5 cm/px over the 40 m x 40 m scene (800x800, rows index x)."""
    n = 800
    r = (np.arange(n) + 0.5) * 0.05
    mx = BOUNDARY[0][0] + r[:, None] * np.ones((1, n))
    my = BOUNDARY[1][0] + np.ones((n, 1)) * r[None, :]
    return scene_class(mx, my)


def write_ground_truth(gt_dir: str):
    """Emit the evaluator's bev-5cm-{road,crosswalks,lanes,mask}.jpg layers
    (OpenCV's JPEG writer; ref test_semantic_mapping.py:45-69)."""
    import cv2

    cls = _truth_5cm()
    n = cls.shape[0]
    quality = [cv2.IMWRITE_JPEG_QUALITY, 100]
    for name, cid in [("road", ROAD), ("crosswalks", CROSS), ("lanes", LANE)]:
        layer = np.where(cls == cid, 255, 0).astype(np.uint8)
        img = np.repeat(layer[:, :, None], 3, axis=2)
        cv2.imwrite(osp.join(gt_dir, f"bev-5cm-{name}.jpg"), img, quality)
    mask = np.full((n, n, 3), 255, np.uint8)
    cv2.imwrite(osp.join(gt_dir, "bev-5cm-mask.jpg"), mask, quality)
    return cls


def write_truth_arrays(gt_dir: str) -> np.ndarray:
    """Write ``truth.npy`` (evaluation labels 1 road, 2 crosswalk, 3 lane at
    the 4x-downsampled 20 cm grid, float64) and ``mask.npy`` (all valid),
    what ``MapEvaluator`` derives from :func:`write_ground_truth`'s JPEGs.
    Every 8x8 block of the 5 cm layers is one class, so the downsampled
    pixel is the class at any of its source pixels."""
    cls = _truth_5cm()[1::4, 1::4]
    truth = np.zeros(cls.shape, np.float64)
    truth[cls == ROAD] = 1
    truth[cls == LANE] = 3
    truth[cls == CROSS] = 2
    np.save(osp.join(gt_dir, "truth.npy"), truth)
    np.save(osp.join(gt_dir, "mask.npy"), np.ones(cls.shape, np.float64))
    return truth


def pose(mx, my, yaw):
    """Map-coord vehicle pose -> world-frame (position, quaternion xyzw)."""
    from ..mapping import PCD_ORIGIN_OFFSET

    position = np.array([mx - PCD_ORIGIN_OFFSET[0], my - PCD_ORIGIN_OFFSET[1], 0.0])
    quaternion = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
    return position, quaternion


def render_frame(position, quaternion, scale=2, cam=None, palette=None):
    """Ray-cast the scene through a camera at a vehicle pose.

    Returns (image_rgb_full, net_labels_full) at the calibration's full
    1920x1440 resolution (rendered at 1/scale and pixel-replicated).
    ``cam`` defaults to camera 1; ``palette`` overrides the per-scene-class
    RGB colours (default INPUT_COLORS).  The pose matrix is built in f32,
    as the JAX package builds it.
    """
    from ..geometry.camera import camera_setup_1
    from ..geometry.transforms import pose_to_matrix
    from ..mapping import PCD_ORIGIN_OFFSET
    from ..mapping.engine import velodyne_to_baselink

    cam = cam or camera_setup_1()
    colors = INPUT_COLORS if palette is None else np.asarray(palette, np.uint8)
    w, h = cam.im_size
    rw, rh = w // scale, h // scale
    xs = (np.arange(rw) + 0.5) * scale - 0.5
    ys = (np.arange(rh) + 0.5) * scale - 0.5
    px, py = np.meshgrid(xs, ys)
    pix = np.stack([px.ravel(), py.ravel(), np.ones(px.size)])

    d_velo = cam.R.T @ (np.linalg.inv(cam.K) @ pix)   # rays, velodyne frame
    c_velo = (-cam.R.T @ cam.t).ravel()
    T = pose_to_matrix(torch.as_tensor(position, dtype=torch.float32),
                       torch.as_tensor(quaternion, dtype=torch.float32))
    T = T.numpy().astype(np.float64) @ velodyne_to_baselink()
    d_w = T[:3, :3] @ d_velo
    c_w = T[:3, :3] @ c_velo + T[:3, 3]

    denom = np.where(d_w[2] == 0, -1e-12, d_w[2])
    s = -c_w[2] / denom
    ground = (d_w[2] < 0) & (s > 0)
    mx = c_w[0] + s * d_w[0] + PCD_ORIGIN_OFFSET[0]
    my = c_w[1] + s * d_w[1] + PCD_ORIGIN_OFFSET[1]
    cls = scene_class(mx, my)
    cls[~ground] = SKY

    img = colors[cls].reshape(rh, rw, 3)
    labels = NET_IDS[cls].reshape(rh, rw)
    img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    labels = np.repeat(np.repeat(labels, scale, axis=0), scale, axis=1)
    return img, labels


def make_poses():
    """9 viewpoints (3x3 lattice, 10 m spacing) x 10 yaw steps (see the JAX
    module for why this lattice: every cell within ~7.1 m of a viewpoint)."""
    poses = []
    viewpoints = [
        (110, 810), (110, 830), (130, 810), (130, 830), (120, 820),
        (120, 810), (120, 830), (110, 820), (130, 820),
    ]
    for cmx, cmy in viewpoints:
        for k in range(10):
            poses.append(pose(cmx, cmy, yaw=k * np.pi / 5))
    return poses


def make_point_map():
    """Static 'reduced_map' point cloud: one point per grid cell center,
    z=0, intensity 8 (inside [2,14] so the lane boost never fires)."""
    from ..mapping import PCD_ORIGIN_OFFSET

    i, j = np.meshgrid(np.arange(GRID_HW[0]), np.arange(GRID_HW[1]), indexing="ij")
    mx = BOUNDARY[0][0] + (i.ravel() + 0.5) * RES
    my = BOUNDARY[1][0] + (j.ravel() + 0.5) * RES
    return np.stack(
        [mx - PCD_ORIGIN_OFFSET[0], my - PCD_ORIGIN_OFFSET[1], np.zeros(mx.size),
         np.full(mx.size, 8.0)]
    ).astype(np.float32)


# --------------------------------------------------------------------------
# Per-operating-point helpers
# --------------------------------------------------------------------------

def scaled_hw(image_scale: float) -> Tuple[int, int]:
    """Network input size at an IMAGE_SCALE (the pipeline's resize_area target)."""
    if image_scale >= 1.0:
        return FULL_HW
    return int(FULL_HW[0] * image_scale), int(FULL_HW[1] * image_scale)


def subsample_labels(labels_full: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-pixel-center subsample of a full-res label map: index
    floor((i + 0.5) * full / out - 0.5), the area resize's pixel centres."""
    oh, ow = out_hw
    fh, fw = labels_full.shape[:2]
    yi = np.clip(np.floor((np.arange(oh) + 0.5) * fh / oh - 0.5), 0, fh - 1).astype(int)
    xi = np.clip(np.floor((np.arange(ow) + 0.5) * fw / ow - 0.5), 0, fw - 1).astype(int)
    return labels_full[np.ix_(yi, xi)]


def scene_network_cfg(weight_path: str = "", backbone: str = "resnet18",
                      output_stride: int = 16, compute_dtype: str = "float32"):
    """App config with the scene's network overrides (ref base_cfg.py:91)."""
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.MODEL.BACKBONE = backbone
    net.MODEL.OUTPUT_STRIDE = int(output_stride)
    net.MODEL.COMPUTE_DTYPE = compute_dtype
    net.MODEL.WEIGHT = weight_path
    return cfg


def apply_scene_mapping_cfg(cfg, image_scale: float = 0.1, upsample_pred: bool = True):
    """Set the scene's mapping geometry + serving knobs on an app config."""
    cfg.MAPPING.RESOLUTION = RES
    cfg.MAPPING.BOUNDARY = BOUNDARY
    cfg.MAPPING.POINT_BUCKET = 2 ** 16
    # every cell is within ~7.1 m of some lattice viewpoint; capping the
    # range keeps far, heavily-quantized observations out of the evidence
    cfg.MAPPING.PCD.RANGE_MAX = 12.0
    cfg.VISION_SEM_SEG.IMAGE_SCALE = float(image_scale)
    cfg.VISION_SEM_SEG.UNDISTORT = False  # frames are rendered pinhole
    cfg.VISION_SEM_SEG.UPSAMPLE_PRED = bool(upsample_pred)
    return cfg


def _mapped_crops(
    images: np.ndarray,
    targets: np.ndarray,
    crop_hw: Tuple[int, int],
    per_frame: int,
    mapped_classes: Tuple[int, ...],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-balanced random crops alternating with uniform-random ones.

    Crops centred on each mapped class in turn (cycling through the classes
    present, so thin classes are not left to chance), every other crop
    uniform-random (so the background keeps its share); the JAX module
    records the measurements behind this policy."""
    ch, cw = crop_hw
    imgs, labs = [], []
    for img, lab in zip(images, targets):
        h, w = lab.shape
        present = [c for c in mapped_classes if (lab == c).any()]
        locs = {c: np.nonzero(lab == c) for c in present}
        ci = 0
        for j in range(per_frame):
            if present and j % 2 == 0:
                ys, xs = locs[present[ci % len(present)]]
                ci += 1
                k = int(rng.integers(ys.size))
                cy, cx = int(ys[k]), int(xs[k])
            else:
                cy = int(rng.integers(h)) if h > ch else h // 2
                cx = int(rng.integers(w)) if w > cw else w // 2
            y0 = int(np.clip(cy - ch // 2, 0, h - ch))
            x0 = int(np.clip(cx - cw // 2, 0, w - cw))
            imgs.append(img[y0 : y0 + ch, x0 : x0 + cw])
            labs.append(lab[y0 : y0 + ch, x0 : x0 + cw])
    return np.stack(imgs), np.stack(labs)


DROPOUT_SEED = 1


def train_segmenter(
    frames: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    weight_path: str,
    backbone: str = "resnet18",
    output_stride: int = 16,
    max_steps: int = 150,
    min_steps: int = 100,
    lr: float = 3e-3,
    mapped_classes: Tuple[int, ...] = (2, 1, 8),
    target_recall: float = 0.93,
    quality_floor: Optional[Tuple[float, float]] = (0.97, 0.85),
    batch_size: Optional[int] = None,
    val_frames: Optional[Sequence[np.ndarray]] = None,
    val_labels: Optional[Sequence[np.ndarray]] = None,
    val_target: Optional[float] = None,
    log=None,
    device="cuda",
) -> float:
    """Overfit DeepLabV3+ to the scene colours; save the weights as a
    ``.pth`` state dict (``MODEL.WEIGHT`` loads it).

    The JAX module's recipe (Adam at ``lr``, model seeded 0, the same
    batches and gates): ``frames`` are float RGB images at the serving
    resolution, ``labels`` their nearest-subsampled network-class maps.
    Training stops on per-class recall and precision of the mapped classes
    on the train batches (after ``min_steps``), and, with held-out views
    (``val_frames``/``val_labels``), on running-statistics recall and
    precision there reaching ``val_target``; or at ``max_steps``.
    ``quality_floor=(acc, min_recall)`` raises if the final weights miss it
    on the train batches (read with the evaluation step); None skips it.
    Returns that accuracy (the last train batch's when the floor is off).
    """
    from ..inference.predictor import IMAGENET_MEAN, IMAGENET_STD
    from ..models.build import build_model
    from ..parallel.train_step import TrainState, make_eval_step, make_train_step
    from ..train.optim import build_scheduler

    if not weight_path.endswith(".pth"):
        raise ValueError(f"weight_path {weight_path!r}: the port saves a .pth state dict")
    if val_target is None:
        val_target = target_recall
    cfg = scene_network_cfg(backbone=backbone, output_stride=output_stride)
    model = build_model(cfg.VISION_SEM_SEG.SEM_SEG_NETWORK, dtype=torch.float32,
                        device=device, generator=torch.Generator().manual_seed(0)).train()
    dev = next(model.parameters()).device

    # the predictor normalizes uint8/255 by ImageNet stats; train on the
    # identical preprocessing so the checkpoint transfers
    images = (np.stack(frames).astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    targets = np.stack(labels).astype(np.int32)
    h, w = targets.shape[1:3]
    crop_hw = (min(h, 513), min(w, 513))
    val_images = val_targets = None
    if val_frames is not None:
        val_images = (np.stack(val_frames).astype(np.float32) / 255.0
                      - IMAGENET_MEAN) / IMAGENET_STD
        val_targets = np.stack(val_labels).astype(np.int32)
    if crop_hw != (h, w):
        # large serving scales: class-balanced 513^2 crops at the same
        # ground sampling distance; at least one per mapped class per frame
        per_frame = max(2 * len(mapped_classes), -(-16 // images.shape[0]))
        images, targets = _mapped_crops(images, targets, crop_hw, per_frame, mapped_classes,
                                        np.random.default_rng(11))
        if val_images is not None:
            val_images, val_targets = _mapped_crops(val_images, val_targets, crop_hw, per_frame,
                                                    mapped_classes, np.random.default_rng(101))
        if batch_size is None:
            batch_size = 4
    n = images.shape[0]
    bsz = n if batch_size is None else min(int(batch_size), n)
    batches = []
    for i in range(0, n, bsz):
        take = np.arange(i, i + bsz) % n  # the last batch wraps to the front
        batches.append({"image": torch.from_numpy(images[take]).to(dev),
                        "label": torch.from_numpy(targets[take]).long().to(dev)})

    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    state = TrainState(model=model, optimizer=optimizer,
                       scheduler=build_scheduler(optimizer, None),
                       generator=torch.Generator(dev).manual_seed(1))
    step = make_train_step(num_classes=19)
    evaluate = make_eval_step(num_classes=19)

    @torch.no_grad()
    def predict(x: np.ndarray) -> np.ndarray:
        model.eval()
        try:
            logits = model(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2), upsample_pred=True)
        finally:
            model.train()
        return logits.argmax(1).cpu().numpy()

    def val_gate():
        """Running-stats recall AND precision on the held-out crops.

        Classes absent from the val crops are skipped for recall, but a
        material false-positive flood of an absent class (> 0.2 % of the
        val pixels) still holds the gate."""
        pred = np.concatenate([predict(val_images[i : i + bsz])
                               for i in range(0, val_images.shape[0], bsz)])
        ok, stats = True, {}
        for c in mapped_classes:
            tp = int(((pred == c) & (val_targets == c)).sum())
            support = int((val_targets == c).sum())
            predicted = int((pred == c).sum())
            r = tp / support if support else float("nan")
            p = tp / predicted if predicted else float("nan")
            stats[c] = (round(r, 4), round(p, 4))
            if support and (r < val_target or not (p >= val_target)):
                ok = False
            if not support and predicted > 0.002 * val_targets.size and p < val_target:
                ok = False
        return ok, stats

    # ASPP's dropout draws from the device's default generator: fork it and
    # seed the fork (the JAX TrainState's own key, PRNGKey(1)), so that the
    # weights do not depend on what drew from it before
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.default_generator.manual_seed(DROPOUT_SEED)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                torch.cuda.manual_seed(DROPOUT_SEED)
        acc, recalls, precisions = 0.0, {}, {}
        val_ok, next_val = val_images is None, 0
        for it in range(max_steps):
            conf = step(state, batches[it % len(batches)])["confusion"].cpu().numpy()
            acc = float(np.trace(conf) / max(conf.sum(), 1.0))
            # a class absent from this batch keeps its last measured value
            for c in mapped_classes:
                if conf[c].sum() > 0:
                    recalls[c] = float(conf[c, c] / conf[c].sum())
                if conf[:, c].sum() > 0:
                    precisions[c] = float(conf[c, c] / conf[:, c].sum())
            if log and (it + 1) % 50 == 0:
                log(f"  train step {it + 1}: acc={acc:.3f} recalls={recalls} "
                    f"precisions={precisions}")
            train_gate = (
                len(recalls) == len(mapped_classes)
                and len(precisions) == len(mapped_classes)
                and min(recalls.values()) >= target_recall
                and min(precisions.values()) >= target_recall
                and it >= min_steps - 1
            )
            if train_gate and not val_ok and it >= next_val:
                val_ok, vstats = val_gate()
                next_val = it + 25  # bound the eval cost while converging
                if log:
                    log(f"  val step {it + 1}: ok={val_ok} (recall, precision)={vstats}")
            if train_gate and val_ok:
                break
    if val_images is not None and not val_ok and log:
        log(f"  WARNING: held-out gate never reached {val_target} within {max_steps} "
            "steps; saving anyway (score will reflect it)")
    if quality_floor is not None:
        # the final weights over one cycle of the train batches, through the
        # evaluation step (running statistics, no update)
        agg = sum(evaluate(state, batch)["confusion"].cpu().numpy() for batch in batches)
        acc = float(np.trace(agg) / max(agg.sum(), 1.0))
        recalls = {c: float(agg[c, c] / agg[c].sum())
                   for c in mapped_classes if agg[c].sum() > 0}
        acc_floor, recall_floor = quality_floor
        floor_recalls = [recalls.get(c, 0.0) for c in mapped_classes]
        if acc < acc_floor or min(floor_recalls) < recall_floor:
            raise AssertionError(f"segmenter failed to overfit the scene: acc={acc:.3f} {recalls}")
    model.eval()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, weight_path)
    return acc


def build_scene_bag(bag_path: str, images, poses) -> str:
    """Write the rendered frames + cell-center cloud as an .npz bag."""
    from ..runtime.io import FrameRecord, save_frames

    pcd = make_point_map()
    frames = [
        FrameRecord(pcd=pcd, pcd_frame_id="world", semantic_image=images[i],
                    position=poses[i][0], quaternion=poses[i][1], camera="camera1",
                    stamp=float(i))
        for i in range(len(poses))
    ]
    save_frames(frames, bag_path)
    return bag_path
