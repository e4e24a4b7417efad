"""Application (mapping pipeline) configuration defaults.

Mirrors `reference: src/config/base_cfg.py:12-112` key-for-key so the
reference's YAML files (e.g. ``config/example.yaml``) merge unchanged.

Port copy of ``vision_semantic_segmentation_tpu/config/defaults.py``, kept key-for-key
so one YAML file configures both packages.
"""
from __future__ import annotations

import os.path as osp

from .node import CN
from .network import get_demo_cfg_defaults

_C = CN()

_C.TASK_NAME = "cfn_mtx_with_intensity"
# '@' means the root directory of the project (ref base_cfg.py:32-33)
_C.OUTPUT_DIR = "@/outputs"
# When a pose timestamp reaches this threshold the map is finalized
# (ref base_cfg.py:38, mapping.py:224-225)
_C.TEST_END_TIME = 1581541450
_C.GROUND_TRUTH_DIR = ""
_C.RNG_SEED = -1

# Label set: indices into the 19-class network output, display names, RGB
# palette used to tag points (ref base_cfg.py:47-57)
_C.LABELS = [2, 1, 8, 10, 3]
_C.LABELS_NAMES = ["road", "crosswalk", "lane", "vegetation", "sidewalk"]
_C.LABEL_COLORS = [
    [128, 64, 128],   # road
    [140, 140, 200],  # crosswalk
    [255, 255, 255],  # lane
    [107, 142, 35],   # vegetation
    [244, 35, 232],   # sidewalk
]

_C.MAPPING = CN()
_C.MAPPING.RESOLUTION = 0.1
_C.MAPPING.BOUNDARY = [[100, 300], [800, 1000]]
_C.MAPPING.DEPTH_METHOD = "points_map"
_C.MAPPING.PCD = CN()
_C.MAPPING.PCD.USE_INTENSITY = True
_C.MAPPING.PCD.RANGE_MAX = 100.0
_C.MAPPING.CONFUSION_MTX = CN()
_C.MAPPING.CONFUSION_MTX.LOAD_PATH = ""
_C.MAPPING.INPUT_DIR = ""

# TPU-specific mapping knobs (no reference equivalent).
# Points per frame are padded/bucketed to this size so every frame runs the
# same compiled program (SURVEY.md section 7 "dynamic point counts").
_C.MAPPING.POINT_BUCKET = 2 ** 17
# Number of mesh shards along the BEV grid row axis (context-parallel
# analogue, SURVEY.md section 5 "long-context").  1 = unsharded.
_C.MAPPING.GRID_SHARDS = 1
# Per-frame update window in cells (0 = dense over the whole grid).  For
# very large grids a pose-centered window makes the update cost
# independent of grid size; size it >= ~2.2 * PCD.RANGE_MAX / RESOLUTION.
_C.MAPPING.UPDATE_WINDOW = 0
# The JAX package's grid-update forms: SORT_METHOD 'bitonic' | 'radix'
# (its key sort), FOLD_METHOD 'matmul' (dense observation buffer + MXU
# evidence fold) | 'scatter' (per-cell evidence vectors, one unique-cell
# scatter).  The port checks both names and runs one update for every
# name (mapping/engine.py: one idempotent scatter plus the K2 fold).
_C.MAPPING.SORT_METHOD = "bitonic"
_C.MAPPING.FOLD_METHOD = "matmul"

_C.VISION_SEM_SEG = CN()
_C.VISION_SEM_SEG.IMAGE_SCALE = 1.0
# Undistort incoming camera frames with the calibration's plumb-bob
# coefficients (ref node:85-87).  Disable for pre-rectified / synthetic
# feeds whose geometry is already pinhole.
_C.VISION_SEM_SEG.UNDISTORT = True
# Bilinearly upsample logits to the network input size before the argmax
# (align_corners, inside the jitted forward).  The reference always
# argmaxes at the decoder's os4 resolution (semantic_segmentation.py:55,
# upsample_pred=False) — fine at IMAGE_SCALE=1.0, but at reduced scales
# the label map becomes (H*scale/4, W*scale/4); enabling this recovers
# 4x finer class boundaries for ~zero cost.
_C.VISION_SEM_SEG.UPSAMPLE_PRED = False

_network = get_demo_cfg_defaults()
_network.TRAIN_DATASET = "Mapillary"
_network.DATASET_CONFIG = ""
_network.MODEL.TYPE = "DeepLabv3+"
_network.MODEL.WEIGHT = ""
_network.MODEL.SYNC_BN = False
_network.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 256
_network.MODEL.BACKBONE = "resnext50_32x4d"
_network.MODEL.OUTPUT_STRIDE = 8
_network.DATASET.NAME = "AVL"
_network.DATASET.IN_CHANNELS = 3
_network.DATASET.NUM_CLASSES = 19
_C.VISION_SEM_SEG.SEM_SEG_NETWORK = _network


def get_cfg_defaults() -> CN:
    """Get a fresh clone of the default app configuration."""
    return _C.clone()


def resolve_output_dir(output_dir: str, task_name: str = "") -> str:
    """Expand the '@' placeholder to the repo root (ref mapping.py:78-83)."""
    if "@" in output_dir:
        root = osp.abspath(osp.join(osp.dirname(__file__), "../../"))
        output_dir = output_dir.replace("@", root)
        if task_name:
            output_dir = osp.join(output_dir, task_name)
        output_dir = osp.abspath(output_dir)
    return output_dir
