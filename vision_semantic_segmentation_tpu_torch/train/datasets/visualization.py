"""Dataset and network-output visualisation helpers.

Port of ``vision_semantic_segmentation_tpu/train/datasets/visualization.py``:

  * Mapillary palette loading and label colourising (ref
    data/utils/mapillary_visualization.py:9-89; the device path is
    ``ops/colormap.py``, these are the host-side wrappers);
  * the BDD trainId -> colour map (ref data/utils/bdd_visualization.py:10-39);
  * network-output panels for TensorBoard: the denormalised input grid and
    the coloured prediction and label grids (ref
    data/utils/visualization.py:65-106).

Host numpy, as in the JAX package; a torch tensor argument is copied to the
host first.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from ...ops.colormap import BDD_TRAINID_COLORS, MAPILLARY_19_PALETTE, palette_from_cfg

__all__ = [
    "get_labels",
    "palette_from_cfg",
    "apply_color_map",
    "bdd_trainid_color_map",
    "apply_bdd_color_map",
    "make_grid",
    "denormalize_images",
    "log_network_outputs",
]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _palette_256(colors) -> np.ndarray:
    palette = np.zeros((256, 3), dtype=np.uint8)
    palette[: len(colors)] = colors
    return palette


def _ids(label_array) -> np.ndarray:
    return _host(label_array).astype(np.int64).clip(0, 255)


def get_labels(dataset_config_path: str) -> List[dict]:
    """Labels metadata of a Mapillary-style config.json (ref :9-33)."""
    with open(dataset_config_path) as f:
        return json.load(f)["labels"]


def apply_color_map(label_array, labels: Sequence[dict]) -> np.ndarray:
    """Label id image -> RGB by ``labels[i]['color']`` (ref :70-89).

    Out-of-range ids (e.g. ignore = 255) render black.
    """
    return _palette_256([label["color"] for label in labels])[_ids(label_array)]


def bdd_trainid_color_map() -> np.ndarray:
    """(256, 3) trainId -> colour palette of the BDD label table."""
    return _palette_256(BDD_TRAINID_COLORS)


def apply_bdd_color_map(label_array) -> np.ndarray:
    return bdd_trainid_color_map()[_ids(label_array)]


def make_grid(images, nrow: int = 4, padding: int = 2) -> np.ndarray:
    """Tile an (N, H, W, C) batch into one (H', W', C) canvas."""
    images = _host(images)
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    canvas = np.zeros((nrows * (h + padding) - padding, ncol * (w + padding) - padding, c),
                      dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        canvas[r * (h + padding): r * (h + padding) + h,
               col * (w + padding): col * (w + padding) + w] = images[i]
    return canvas


def denormalize_images(images, mean=(0.485, 0.456, 0.406),
                       std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """Undo ImageNet normalisation back to uint8 (ref visualization.py:65-80)."""
    x = _host(images) * np.asarray(std) + np.asarray(mean)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def log_network_outputs(writer, tag: str, images, preds, labels, global_step: int,
                        dataset_labels: Optional[Sequence[dict]] = None,
                        nrow: int = 4) -> None:
    """Write input, prediction and label panels through ``writer`` (ref :82-106).

    Args:
        writer: any object with ``add_image(tag, img, step, dataformats=...)``
            (a tensorboardX ``SummaryWriter``, for one).
        images: (N, H, W, 3) normalised inputs; preds / labels: (N, H, W) ids.
    """
    if dataset_labels is not None:
        palette = _palette_256([label["color"] for label in dataset_labels])
    else:
        palette = _palette_256(MAPILLARY_19_PALETTE)
    img_grid = make_grid(denormalize_images(images), nrow)
    pred_grid = make_grid(palette[_ids(preds)], nrow)
    label_grid = make_grid(palette[_ids(labels)], nrow)
    writer.add_image(f"{tag}/image", img_grid, global_step, dataformats="HWC")
    writer.add_image(f"{tag}/prediction", pred_grid, global_step, dataformats="HWC")
    writer.add_image(f"{tag}/label", label_grid, global_step, dataformats="HWC")
