"""Network training / inference configuration trees.

Mirrors the reference's three composable config roots:
  * training root        `reference: src/network/deeplab_v3_plus/config/base.py`
  * DeepLabV3+ overlay   `.../config/deeplab_v3_plus.py`
  * demo/inference cfg   `.../config/demo.py`

Keys and defaults are kept identical so the reference's YAML experiment
files merge cleanly; only the values' meanings are reinterpreted for the
TPU runtime (e.g. ``DATALOADER.PIN_MEMORY`` maps to host->device
double-buffering instead of CUDA pinned memory).

Port copy of ``vision_semantic_segmentation_tpu/config/network.py``, kept key-for-key
so one YAML file configures both packages.
"""
from __future__ import annotations

from .node import CN

DISABLE = 0


def _train_base() -> CN:
    """Training root config (ref config/base.py:18-179)."""
    _C = CN()
    _C.TASK_NAME = ""
    _C.AUTO_RESUME = True
    _C.RESUME_STATES = True

    _C.MODEL = CN()
    _C.MODEL.TYPE = ""
    _C.MODEL.WEIGHT = ""
    # On TPU, batch norm statistics are computed over the *global* (mesh-wide)
    # batch inside jit, so SYNC_BN=True is the natural SPMD behavior; when
    # False we fall back to per-device statistics via a sharded pmean group.
    _C.MODEL.SYNC_BN = False

    _C.DATASET = CN()
    _C.DATASET.NAME = ""
    _C.DATASET.IN_CHANNELS = 0
    _C.DATASET.NUM_CLASSES = 0
    _C.DATASET.ROOT_DIR = ""
    _C.DATASET.TRAIN = ""
    _C.DATASET.VAL = ""
    _C.DATASET.TEST = ""

    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 0
    _C.DATALOADER.DROP_LAST = True
    # accepted for YAML compatibility; host->device staging is always
    # double-buffered here (runtime/replay.py), so there is no CUDA
    # pinned-memory analogue to toggle
    _C.DATALOADER.PIN_MEMORY = True
    # batches decoded AHEAD on a background thread while the device runs
    # the previous dispatch (train/prefetch.py — the role torch's worker
    # prefetch plays in the reference, data/build.py:95-103); ordering
    # preserved exactly, 0 disables
    _C.DATALOADER.PREFETCH_BATCHES = 2

    _C.OPTIMIZER = CN()
    _C.OPTIMIZER.TYPE = ""
    _C.OPTIMIZER.BASE_LR = 0.001
    _C.OPTIMIZER.WEIGHT_DECAY = 0.0
    _C.OPTIMIZER.MAX_GRAD_NORM = DISABLE
    _C.OPTIMIZER.SGD = CN()
    _C.OPTIMIZER.SGD.momentum = 0.0
    _C.OPTIMIZER.SGD.dampening = 0.0
    _C.OPTIMIZER.SGD.nesterov = False
    _C.OPTIMIZER.Adam = CN()
    _C.OPTIMIZER.Adam.betas = (0.9, 0.999)

    _C.SCHEDULER = CN()
    _C.SCHEDULER.TYPE = ""
    _C.SCHEDULER.MAX_EPOCH = 1
    # accepted for YAML compatibility (the reference defines but never
    # consumes it either, ref config/base.py:100)
    _C.SCHEDULER.CLIP_LR = 0.0
    _C.SCHEDULER.StepLR = CN()
    _C.SCHEDULER.StepLR.step_size = 0
    _C.SCHEDULER.StepLR.gamma = 0.1
    _C.SCHEDULER.MultiStepLR = CN()
    _C.SCHEDULER.MultiStepLR.milestones = ()
    _C.SCHEDULER.MultiStepLR.gamma = 0.1
    _C.SCHEDULER.PolyLRDecay = CN()
    _C.SCHEDULER.PolyLRDecay.max_iter = 300
    _C.SCHEDULER.PolyLRDecay.power = 0.9

    _C.TRAIN = CN()
    _C.TRAIN.BATCH_SIZE = 1
    _C.TRAIN.CHECKPOINT_PERIOD = DISABLE
    # Non-blocking checkpoint saves (TPU-specific; no reference
    # equivalent): Orbax snapshots the arrays synchronously, then
    # serializes/writes on a background thread while the epoch loop keeps
    # dispatching; the last_checkpoint pointer commits only when the
    # write completes (train/checkpoint.py::Checkpoint.save(block=False))
    _C.TRAIN.ASYNC_CHECKPOINT = False
    # Preemption-safe training (TPU-specific; the reference has no failure
    # handling at all — SURVEY.md §5 "failure detection: None"): while
    # fit() runs, SIGTERM requests a checkpoint at the next step boundary;
    # the state (params/BN/optimizer/step/rng) commits via the
    # last_checkpoint pointer and fit() returns cleanly.  AUTO_RESUME then
    # continues MID-EPOCH from the exact saved step (deterministic loaders
    # replay the skipped batches), so a preempted-and-resumed run matches
    # an uninterrupted one step-for-step.
    _C.TRAIN.PREEMPTION_SAFE = True
    _C.TRAIN.LOG_PERIOD = DISABLE
    # TPU-specific (no reference equivalent): train steps fused per device
    # dispatch via lax.scan. Dispatch overhead is per call and scales with
    # the parameter-tree size; >1 amortizes it (essential on tunneled TPUs).
    _C.TRAIN.STEPS_PER_DISPATCH = 1
    # TPU-specific (no reference equivalent): conv-path compute dtype for
    # training.  "bfloat16" keeps parameters/optimizer/loss/grads in f32
    # (flax dtype semantics) while activations run on the MXU's native
    # bf16 path; the reference trains f32 on CUDA.
    _C.TRAIN.COMPUTE_DTYPE = "float32"
    # TPU-specific: rematerialize each backbone residual block under the
    # backward pass (nn.remat).  Loss is bit-identical and grads agree to
    # f32 reassociation noise; residuals are kept only at block
    # boundaries, cutting peak activation memory so larger batches/crops
    # fit device memory.  Costs ~1 extra forward of FLOPs.
    _C.TRAIN.REMAT_BACKBONE = False
    # TPU-specific: split each batch into N micro-batches, accumulate
    # gradients over a lax.scan, apply ONE averaged optimizer update —
    # emulates batches that exceed HBM.  Exact full-batch gradient for
    # BN-free models; with BatchNorm the batch statistics are
    # micro-batch-local.  BATCH_SIZE must divide by it.  Requires the
    # SyncBN/jit step (SYNC_BN=True or a single device).
    _C.TRAIN.GRAD_ACCUM_STEPS = 1
    # TPU-specific: shard the image/label H (row) dimension over this many
    # devices during training — GSPMD spatial partitioning with conv halo
    # exchanges in forward AND backward (parallel/train_step.py::
    # jit_spatial_train_step).  Activation memory divides by the shard
    # count, unlocking crop sizes one chip's HBM cannot hold; parameters
    # stay replicated.  Device count must divide by it; the remaining
    # factor becomes the data axis.  Requires the SyncBN/jit step and
    # host-side augmentation (DEVICE_AUGMENT composes with dp only).
    _C.TRAIN.SPATIAL_SHARDS = 1
    _C.TRAIN.AUGMENTATION = ()
    # TPU-specific: run the training augmentation chain (random scale ->
    # pad -> crop -> horizontal flip -> ImageNet normalize) ON DEVICE
    # inside the jitted train step (train/augment.py).  The host then
    # supplies raw fixed-shape uint8 batches (TRAIN.AUGMENTATION should
    # contain at most a Resize) — removes per-sample PIL work from the
    # training critical path and uploads 4x fewer bytes.  Semantics
    # mirror RandomSizeAndCrop(SIZE, SCALE) + RandomHorizontalFlip +
    # ToTensor + Normalize.
    _C.TRAIN.DEVICE_AUGMENT = CN()
    _C.TRAIN.DEVICE_AUGMENT.ENABLED = False
    _C.TRAIN.DEVICE_AUGMENT.SIZE = 513
    _C.TRAIN.DEVICE_AUGMENT.SCALE = (0.5, 2.0)
    _C.TRAIN.DEVICE_AUGMENT.FLIP_P = 0.5
    _C.TRAIN.DEVICE_AUGMENT.IGNORE_INDEX = 255
    # 0 = disabled; otherwise pre-scale so min(H, W) == PRE_SIZE before
    # the random scale draw (ref RandomSizeAndCrop.pre_size)
    _C.TRAIN.DEVICE_AUGMENT.PRE_SIZE = 0
    _C.TRAIN.FROZEN_PATTERNS = ()
    _C.TRAIN.FREEZE_BATCHNORM = False

    _C.VALIDATE = CN()
    _C.VALIDATE.BATCH_SIZE = 1
    _C.VALIDATE.PERIOD = DISABLE
    _C.VALIDATE.LOG_PERIOD = DISABLE
    # accepted for YAML compatibility (unused by the reference too);
    # validation always reports mIoU + loss here
    _C.VALIDATE.METRIC = ""
    _C.VALIDATE.AUGMENTATION = ()

    _C.TEST = CN()
    _C.TEST.BATCH_SIZE = 1
    _C.TEST.LOG_PERIOD = DISABLE
    _C.TEST.WEIGHT = ""
    _C.TEST.AUGMENTATION = ()

    _C.OUTPUT_DIR = "@"
    _C.RNG_SEED = -1
    return _C


def _add_deeplab(cfg: CN) -> CN:
    """DeepLabV3+ overlay (ref config/deeplab_v3_plus.py:7-34)."""
    cfg.DATASET.IN_CHANNELS = 3
    cfg.DATASET.NUM_CLASSES = 21
    cfg.MODEL.TYPE = "DeepLabv3+"
    cfg.MODEL.BACKBONE = "resnet"
    cfg.MODEL.OUTPUT_STRIDE = 16
    cfg.MODEL.ASPP = CN()
    cfg.MODEL.ASPP.OUT_CHANNELS = 256
    cfg.MODEL.ASPP.ATROUS_CHANNELS = [256, 256, 256, 256]
    cfg.MODEL.ASPP.ATROUS_KERNEL_SIZE = [1, 3, 3, 3]
    cfg.MODEL.ASPP.ATROUS_DILATION = [1, 6, 12, 18]
    cfg.MODEL.ASPP.DROPOUT = 0.5
    cfg.MODEL.DECODER = CN()
    cfg.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 48
    cfg.MODEL.DECODER.REFINE_CHANNELS = [256, 256]
    cfg.MODEL.DECODER.REFINE_KERNEL_SIZE = [3, 3]
    return cfg


def get_train_cfg_defaults() -> CN:
    """Full training config (base + DeepLab overlay)."""
    return _add_deeplab(_train_base()).clone()


def get_demo_cfg_defaults() -> CN:
    """Inference/demo config (ref config/demo.py:8-44)."""
    _C = CN()
    _C.OUTPUT_DIR = "@"
    _C.OUTPUT_NAME = ""
    _C.TRAIN_DATASET = ""
    _C.DATASET_CONFIG = ""

    _C.DATASET = CN()
    _C.DATASET.NAME = ""
    _C.DATASET.IN_CHANNELS = 0
    _C.DATASET.NUM_CLASSES = 0
    _C.DATASET.ROOT_DIR = ""

    _C.MODEL = CN()
    _C.MODEL.TYPE = ""
    _C.MODEL.WEIGHT = ""
    _C.MODEL.SYNC_BN = False

    deeplab = get_train_cfg_defaults()
    _C.MODEL.BACKBONE = deeplab.MODEL.BACKBONE
    _C.MODEL.OUTPUT_STRIDE = deeplab.MODEL.OUTPUT_STRIDE
    _C.MODEL.ASPP = deeplab.MODEL.ASPP.clone()
    _C.MODEL.DECODER = deeplab.MODEL.DECODER.clone()

    # TPU-specific inference knobs (no reference equivalent): compute dtype
    # for the conv path and static input bucketing to avoid recompiles.
    _C.MODEL.COMPUTE_DTYPE = "bfloat16"
    # optional int8 PTQ pack produced by the `quantize` CLI command
    # (models/quant.py); when set, the predictor serves the int8 path
    _C.MODEL.QPACK = ""
    # spatially-sharded (model-parallel) serving: > 1 bands every frame's
    # rows over that many devices with GSPMD conv halo exchanges — exact,
    # cuts single-frame latency below one chip (parallel/spatial_infer.py)
    _C.MODEL.SPATIAL_SHARDS = 0
    return _C
