"""Palette <-> label conversions.

Port of ``vision_semantic_segmentation_tpu/ops/colormap.py``.  The
reference tags 3-D points with RGB colours gathered from the semantic image
and matches them back to class indices by exact equality (ref
mapping.py:387,414-424), and renders maps by palette lookup (ref
data/utils/mapillary_visualization.py:70-89).  ``palette_from_cfg`` is an
own copy of ``train/datasets/visualization.py::palette_from_cfg`` (the
segmentation node's palette choice).
"""
from __future__ import annotations

import json

import numpy as np
import torch

# The 19-class palette shipped with the reference (config/config_19.json
# labels[i]['color']), used when no dataset config is given.
MAPILLARY_19_PALETTE = np.array(
    [
        [196, 196, 196],  # 0  Curb
        [140, 140, 200],  # 1  Crosswalk - Plain
        [128, 64, 128],   # 2  Road
        [244, 35, 232],   # 3  Sidewalk
        [70, 70, 70],     # 4  Building
        [220, 20, 60],    # 5  Person
        [255, 0, 0],      # 6  Bicyclist
        [255, 0, 100],    # 7  Motorcyclist
        [255, 255, 255],  # 8  Lane Marking - General
        [70, 130, 180],   # 9  Sky
        [107, 142, 35],   # 10 Vegetation
        [100, 128, 160],  # 11 Manhole
        [153, 153, 153],  # 12 Pole
        [220, 220, 0],    # 13 Traffic Sign (Front)
        [119, 11, 32],    # 14 Bicycle
        [0, 60, 100],     # 15 Bus
        [0, 0, 142],      # 16 Car
        [0, 0, 230],      # 17 Motorcycle
        [0, 0, 70],       # 18 Truck
    ],
    dtype=np.uint8,
)

# BDD100K trainId -> colour for trainIds 0..18 (the label table of
# train/datasets/bdd.py; every other trainId renders black)
BDD_TRAINID_COLORS = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
        [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)


def load_palette_from_dataset_config(path: str) -> np.ndarray:
    """The (num_classes, 3) palette of a Mapillary-style config.json.

    The reference reads ``labels[i]['color']`` from the dataset config
    (ref mapillary_visualization.py:9-33, config/config_19.json).
    """
    with open(path) as f:
        config = json.load(f)
    return np.array([label["color"] for label in config["labels"]], dtype=np.uint8)


def palette_from_cfg(net_cfg) -> np.ndarray:
    """Label palette selected by the network config (None: Mapillary-19).

    The reference's choice: the video demo switches on ``TRAIN_DATASET``
    (ref video_generator.py:24-27, 96-101) and the segmentation node reads
    the colours of the ``DATASET_CONFIG`` labels JSON (ref
    vision_semantic_segmentation_node.py:62-63).  Falls back to the
    built-in Mapillary-19 palette.
    """
    if net_cfg is None:
        return MAPILLARY_19_PALETTE
    train_dataset = str(net_cfg.TRAIN_DATASET) if "TRAIN_DATASET" in net_cfg else ""
    if train_dataset.upper() == "BDD":
        palette = np.zeros((256, 3), dtype=np.uint8)
        palette[: len(BDD_TRAINID_COLORS)] = BDD_TRAINID_COLORS
        return palette
    dataset_config = str(net_cfg.DATASET_CONFIG) if "DATASET_CONFIG" in net_cfg else ""
    if dataset_config:
        palette = np.zeros((256, 3), dtype=np.uint8)
        with open(dataset_config) as f:
            for i, label in enumerate(json.load(f)["labels"]):
                palette[i] = label["color"]
        return palette
    return MAPILLARY_19_PALETTE


def apply_color_map(labels: torch.Tensor, palette) -> torch.Tensor:
    """Class-index image (H, W) -> RGB (H, W, 3) uint8 via palette gather."""
    palette = torch.as_tensor(np.asarray(palette, dtype=np.uint8), device=labels.device)
    return palette[labels.long()]


def colors_to_labels(rgb: torch.Tensor, palette, fill: int = -1) -> torch.Tensor:
    """RGB colours (..., 3) -> int32 class indices by exact palette match.

    The first matching palette entry wins; no match gives ``fill``.
    """
    palette = torch.as_tensor(np.asarray(palette), device=rgb.device).to(rgb.dtype)
    eq = torch.all(rgb[..., None, :] == palette, dim=-1)  # (..., C)
    idx = torch.argmax(eq.to(torch.int32), dim=-1)
    matched = torch.any(eq, dim=-1)
    return torch.where(matched, idx, fill).to(torch.int32)
