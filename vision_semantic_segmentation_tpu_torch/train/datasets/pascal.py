"""Pascal VOC 2012 segmentation reader (ref data/dataset/pascal.py:8-117).

Port of ``vision_semantic_segmentation_tpu/train/datasets/pascal.py``:
``ImageSets/Segmentation/{train,val}.txt`` name the images,
``JPEGImages/<id>.jpg`` and ``SegmentationClass/<id>.png`` (palette PNGs,
read as their class indices).  Images are read through
``utils/image_io.read_image`` as uint8 arrays.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict

from ...utils.image_io import read_image
from .base import Dataset


class VOCSegmentation(Dataset):
    TYPE_MAP = {"train": "train.txt", "val": "val.txt"}

    def __init__(self, root_dir: str, type: str, transform=None):
        if type not in self.TYPE_MAP:
            raise ValueError(f"dataset split {type!r} not in {sorted(self.TYPE_MAP)}")
        self.root_dir = osp.abspath(root_dir)
        self.split_file = osp.join(self.root_dir, "ImageSets/Segmentation", self.TYPE_MAP[type])
        self.image_dir = osp.join(self.root_dir, "JPEGImages")
        self.seg_label_dir = osp.join(self.root_dir, "SegmentationClass")
        self.transform = transform
        self.image_id_list = self._read_file(self.split_file)

    def __len__(self):
        return len(self.image_id_list)

    def __getitem__(self, index: int) -> Dict:
        image_id = self.image_id_list[index]
        sample = {
            "image": read_image(osp.join(self.image_dir, image_id) + ".jpg"),
            "label": read_image(osp.join(self.seg_label_dir, image_id) + ".png"),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    @staticmethod
    def _read_file(filename: str):
        with open(filename) as f:
            return [line.rstrip("\n") for line in f.readlines()]


class OverfitVOCSegmentation(VOCSegmentation):
    """Size-capped variant for overfitting runs (ref pascal.py:66-108)."""

    def __init__(self, root_dir: str, type: str, size: int, transform=None):
        super().__init__(root_dir, type, transform)
        if size > len(self.image_id_list):
            raise ValueError(f"size {size} > the split's {len(self.image_id_list)} images")
        self.image_id_list = self.image_id_list[:size]
