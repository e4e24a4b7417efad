"""Mapillary Vistas dataset reader (ref data/dataset/mapillary.py:11-79).

Port of ``vision_semantic_segmentation_tpu/train/datasets/mapillary.py``:
``config.json`` with the label table, ``{training,validation,testing}/
{images/<id>.jpg, labels/<id>.png}``.  Images are read through
``utils/image_io.read_image`` (Pillow when installed, else the port's PNG
decoder), as uint8 arrays.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict

from ...utils.image_io import read_image
from .base import Dataset


class MapillaryVistas(Dataset):
    SUBDIR = {"train": "training", "test": "testing", "val": "validation"}

    def __init__(self, root_dir: str, type: str, transform=None):
        if type not in self.SUBDIR:
            raise ValueError(f"dataset split {type!r} not in {sorted(self.SUBDIR)}")
        self.root_dir = osp.abspath(root_dir)
        self.transform = transform
        self.type = type

        with open(osp.join(self.root_dir, "config.json")) as f:
            self.labels = json.load(f)["labels"]

        self.image_dir = osp.join(self.root_dir, self.SUBDIR[type], "images")
        self.label_dir = osp.join(self.root_dir, self.SUBDIR[type], "labels")
        self.image_ids = sorted(self.get_filenames(self.image_dir))

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, index: int) -> Dict:
        image_id = self.image_ids[index]
        sample = {
            "image": read_image(osp.join(self.image_dir, f"{image_id}.jpg")),
            "label": read_image(osp.join(self.label_dir, f"{image_id}.png")),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
