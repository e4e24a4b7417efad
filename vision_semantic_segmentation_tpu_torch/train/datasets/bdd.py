"""Berkeley DeepDrive segmentation dataset (ref data/dataset/bdd.py:11-152).

Port of ``vision_semantic_segmentation_tpu/train/datasets/bdd.py``.  The
41-entry label table is Cityscapes-derived public dataset metadata (BDD100K
label spec); trainIds are Cityscapes-compatible.  The reader takes the
layout that ``preparation.prepare_labels(kind="bdd")`` writes:
``seg/images/<split>/<id>.jpg`` and
``seg/color_labels_preprocessed/<split>/<id>_train_color.png`` (single-channel
trainIds).  Images are read through ``utils/image_io.read_image`` as uint8
arrays.
"""
from __future__ import annotations

import os.path as osp
from collections import namedtuple
from typing import Dict

from ...utils.image_io import read_image
from .base import Dataset

Label = namedtuple(
    "Label",
    ["name", "id", "trainId", "category", "categoryId", "hasInstances", "ignoreInEval", "color"],
)

# name, id, trainId, category, catId, hasInstances, ignoreInEval, color
labels = [
    Label("unlabeled", 0, 255, "void", 0, False, True, (0, 0, 0)),
    Label("dynamic", 1, 255, "void", 0, False, True, (111, 74, 0)),
    Label("ego vehicle", 2, 255, "void", 0, False, True, (0, 0, 0)),
    Label("ground", 3, 255, "void", 0, False, True, (81, 0, 81)),
    Label("static", 4, 255, "void", 0, False, True, (0, 0, 0)),
    Label("parking", 5, 255, "flat", 1, False, True, (250, 170, 160)),
    Label("rail track", 6, 255, "flat", 1, False, True, (230, 150, 140)),
    Label("road", 7, 0, "flat", 1, False, False, (128, 64, 128)),
    Label("sidewalk", 8, 1, "flat", 1, False, False, (244, 35, 232)),
    Label("bridge", 9, 255, "construction", 2, False, True, (150, 100, 100)),
    Label("building", 10, 2, "construction", 2, False, False, (70, 70, 70)),
    Label("fence", 11, 4, "construction", 2, False, False, (190, 153, 153)),
    Label("garage", 12, 255, "construction", 2, False, True, (180, 100, 180)),
    Label("guard rail", 13, 255, "construction", 2, False, True, (180, 165, 180)),
    Label("tunnel", 14, 255, "construction", 2, False, True, (150, 120, 90)),
    Label("wall", 15, 3, "construction", 2, False, False, (102, 102, 156)),
    Label("banner", 16, 255, "object", 3, False, True, (250, 170, 100)),
    Label("billboard", 17, 255, "object", 3, False, True, (220, 220, 250)),
    Label("lane divider", 18, 255, "object", 3, False, True, (255, 165, 0)),
    Label("parking sign", 19, 255, "object", 3, False, False, (220, 20, 60)),
    Label("pole", 20, 5, "object", 3, False, False, (153, 153, 153)),
    Label("polegroup", 21, 255, "object", 3, False, True, (153, 153, 153)),
    Label("street light", 22, 255, "object", 3, False, True, (220, 220, 100)),
    Label("traffic cone", 23, 255, "object", 3, False, True, (255, 70, 0)),
    Label("traffic device", 24, 255, "object", 3, False, True, (220, 220, 220)),
    Label("traffic light", 25, 6, "object", 3, False, False, (250, 170, 30)),
    Label("traffic sign", 26, 7, "object", 3, False, False, (220, 220, 0)),
    Label("traffic sign frame", 27, 255, "object", 3, False, True, (250, 170, 250)),
    Label("terrain", 28, 9, "nature", 4, False, False, (152, 251, 152)),
    Label("vegetation", 29, 8, "nature", 4, False, False, (107, 142, 35)),
    Label("sky", 30, 10, "sky", 5, False, False, (70, 130, 180)),
    Label("person", 31, 11, "human", 6, True, False, (220, 20, 60)),
    Label("rider", 32, 12, "human", 6, True, False, (255, 0, 0)),
    Label("bicycle", 33, 18, "vehicle", 7, True, False, (119, 11, 32)),
    Label("bus", 34, 15, "vehicle", 7, True, False, (0, 60, 100)),
    Label("car", 35, 13, "vehicle", 7, True, False, (0, 0, 142)),
    Label("caravan", 36, 255, "vehicle", 7, True, True, (0, 0, 90)),
    Label("motorcycle", 37, 17, "vehicle", 7, True, False, (0, 0, 230)),
    Label("trailer", 38, 255, "vehicle", 7, True, True, (0, 0, 110)),
    Label("train", 39, 16, "vehicle", 7, True, False, (0, 80, 100)),
    Label("truck", 40, 14, "vehicle", 7, True, False, (0, 0, 70)),
]



class BDDSegmentation(Dataset):
    """Reads the preprocessed (color-label -> trainId) BDD layout."""

    SPLITS = ("train", "test", "val")

    def __init__(self, root_dir: str, type: str, transform=None, ignore_index: int = 255):
        if type not in self.SPLITS:
            raise ValueError(f"dataset split {type!r} not in {self.SPLITS}")
        self.root_dir = osp.abspath(root_dir)
        self.transform = transform
        self.type = type
        self.ignore_index = ignore_index

        self.image_dir = osp.join(self.root_dir, "seg/images", type)
        self.seglabel_dir = osp.join(self.root_dir, "seg/color_labels_preprocessed", type)
        if not osp.exists(self.image_dir):
            raise FileNotFoundError(f"Cannot find {self.image_dir}")
        if not osp.exists(self.seglabel_dir):
            raise FileNotFoundError(f"Cannot find {self.seglabel_dir}\nDid you preprocess the data?")
        # os.listdir order, as the JAX package's reader keeps it
        self.image_list = self.get_filenames(self.image_dir)

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index: int) -> Dict:
        image_index = self.image_list[index]
        sample = {
            "image": read_image(osp.join(self.image_dir, image_index + ".jpg")),
            "label": read_image(osp.join(self.seglabel_dir, image_index + "_train_color.png")),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
