"""Offline dataset label preparation (host data parallelism).

Port of ``vision_semantic_segmentation_tpu/train/datasets/preparation.py``:
  * Mapillary 66 -> 19 class remap with WHITE_LIST / MERGE_LABEL /
    IGNORE_INDEX=255 (ref data/utils/mapillary_preparation.py:21-73)
  * BDD color-label -> trainId conversion (ref data/utils/bdd_preparation.py)

The per-file work fans out over a thread pool (PIL decode and encode and
one numpy take release the GIL), and the label remap is one vectorized
``take``.  The label images are read and written through Pillow, as the
JAX package does, so the files are byte for byte the JAX package's; Pillow
is imported inside the functions, so the package imports without it.
"""
from __future__ import annotations

import functools
import json
import os
import os.path as osp
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

IGNORE_INDEX = 255

# Mapillary white-list scheme (ref mapillary_preparation.py:23-48):
# the 19 kept source labels, in order -> new ids 0..18
WHITE_LIST = [2, 8, 13, 15, 17, 19, 20, 21, 24, 27, 30, 41, 45, 50, 52, 54, 55, 57, 61]
# source labels merged INTO a white-listed label
MERGE_LABEL = {
    8: [23],   # crosswalk merges zebra
    17: [16],  # bridge -> building
    19: [22],  # human group -> person
    30: [29],  # terrain -> vegetation
    50: [49],  # traffic sign back -> front
}


def _read_label(path: str, rgb: bool = False) -> np.ndarray:
    import PIL.Image

    with PIL.Image.open(path) as image:
        return np.asarray(image.convert("RGB") if rgb else image)


def _write_label(path: str, label: np.ndarray) -> None:
    import PIL.Image

    PIL.Image.fromarray(label).save(path)


def mapillary_label_map(num_source_labels: int = 66) -> np.ndarray:
    """(num_source_labels,) lookup: source label -> new id (255 = ignore)."""
    table = np.full(num_source_labels, IGNORE_INDEX, dtype=np.uint8)
    for new_id, src in enumerate(WHITE_LIST):
        table[src] = new_id
    for target, sources in MERGE_LABEL.items():
        for src in sources:
            table[src] = WHITE_LIST.index(target)
    return table


def convert_label_image(label_path: str, save_path: str, table: np.ndarray) -> None:
    """Remap one label image through the lookup table (one vectorized take)."""
    label = _read_label(label_path)
    remapped = table[np.minimum(label, len(table) - 1)]
    remapped = np.where(label >= len(table), IGNORE_INDEX, remapped)
    _write_label(save_path, remapped.astype(np.uint8))


def bdd_color_to_trainid_table() -> Dict[Tuple[int, int, int], int]:
    """BDD color -> trainId map from the label table (ref bdd_preparation)."""
    from .bdd import labels

    table: Dict[Tuple[int, int, int], int] = {}
    for label in labels:
        # first definition wins (Cityscapes inverse-mapping convention)
        table.setdefault(tuple(label.color), label.trainId)
    return table


def convert_bdd_color_label(label_path: str, save_path: str) -> None:
    """Color-coded BDD label image -> single-channel trainId image."""
    color = _read_label(label_path, rgb=True)
    out = np.full(color.shape[:2], IGNORE_INDEX, dtype=np.uint8)
    for rgb, train_id in bdd_color_to_trainid_table().items():
        out[np.all(color == np.array(rgb, np.uint8), axis=-1)] = train_id
    _write_label(save_path, out)


def _work(task, kind: str, table=None) -> int:
    src, dst = task
    if kind == "mapillary":
        convert_label_image(src, dst, table)
    else:
        convert_bdd_color_label(src, dst)
    return 1


def prepare_labels(label_dir: str, save_dir: str, kind: str = "mapillary", num_workers: int = 4,
                   num_source_labels: int = 66, progress: bool = False) -> int:
    """Convert every ``.png`` label image of a directory (``kind`` "mapillary"
    or "bdd"), in parallel.  Returns the number of converted files.
    ``progress`` is accepted for the JAX signature and prints nothing."""
    os.makedirs(save_dir, exist_ok=True)
    tasks = [(osp.join(label_dir, f), osp.join(save_dir, f))
             for f in sorted(os.listdir(label_dir)) if f.endswith(".png")]
    table = mapillary_label_map(num_source_labels) if kind == "mapillary" else None
    worker = functools.partial(_work, kind=kind, table=table)
    if num_workers <= 1:
        return sum(worker(t) for t in tasks)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return sum(pool.map(worker, tasks))


def prepare_mapillary(data_dir: str, save_dir: str, num_workers: int = 4) -> None:
    """Full Mapillary preparation: remap labels per split, link images,
    write the 19-class config.json (ref mapillary_preparation.py:157-...)."""
    os.makedirs(save_dir, exist_ok=True)
    with open(osp.join(data_dir, "config.json")) as f:
        config = json.load(f)
    # reduced label set in WHITE_LIST order
    config["labels"] = [config["labels"][i] for i in WHITE_LIST]
    with open(osp.join(save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)

    for split in ("training", "validation"):
        src_split = osp.join(data_dir, split)
        if not osp.isdir(src_split):
            continue
        dst_split = osp.join(save_dir, split)
        os.makedirs(osp.join(dst_split, "images"), exist_ok=True)
        prepare_labels(osp.join(src_split, "labels"), osp.join(dst_split, "labels"),
                       kind="mapillary", num_workers=num_workers,
                       num_source_labels=len(config.get("labels-source", [])) or 66)
        for name in os.listdir(osp.join(src_split, "images")):
            src = osp.join(src_split, "images", name)
            dst = osp.join(dst_split, "images", name)
            if not osp.exists(dst):
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copyfile(src, dst)
