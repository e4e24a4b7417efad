"""Dataloader + transform builders (ref data/build.py:10-104).

Port of ``vision_semantic_segmentation_tpu/train/build.py``:
``DATASET.NAME`` Mapillary, BDD or Pascal, on one device.
"""
from __future__ import annotations

from . import transforms as T
from .datasets import BDDSegmentation, DataLoader, MapillaryVistas, VOCSegmentation


def build_transform(augmentation):
    """Tuple-of-(name | (name, *args)) -> Compose (ref data/build.py:10-40)."""
    transform_list = []
    for method in augmentation:
        if isinstance(method, (tuple, list)):
            name, args = method[0], list(method[1:])
        else:
            name, args = method, None
        if not hasattr(T, name):
            raise NotImplementedError(f"Unknown transform {name!r}")
        cls = getattr(T, name)
        transform_list.append(cls(*args) if args else cls())
    return T.Compose(transform_list)


def build_dataloader(cfg, mode: str = "train") -> DataLoader:
    """Mode-driven dataset + loader construction (ref data/build.py:43-104)."""
    if mode == "train":
        batch_size = cfg.TRAIN.BATCH_SIZE
        augmentation = cfg.TRAIN.AUGMENTATION
    elif mode == "val":
        batch_size = cfg.VALIDATE.BATCH_SIZE
        augmentation = cfg.VALIDATE.AUGMENTATION
    elif mode == "test":
        batch_size = cfg.TEST.BATCH_SIZE
        augmentation = cfg.TEST.AUGMENTATION
    else:
        raise NotImplementedError(f"Unknown mode {mode!r}")

    transform = build_transform(augmentation)
    name = cfg.DATASET.NAME
    if name == "Pascal":
        dataset = VOCSegmentation(cfg.DATASET.ROOT_DIR, type=mode, transform=transform)
    elif name == "BDD":
        dataset = BDDSegmentation(cfg.DATASET.ROOT_DIR, type=mode, transform=transform,
                                  ignore_index=255)
    elif name == "Mapillary":
        dataset = MapillaryVistas(cfg.DATASET.ROOT_DIR, type=mode, transform=transform)
    else:
        raise NotImplementedError(f"Unsupported dataset: {name}")

    is_train = mode == "train"
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=is_train,
        drop_last=is_train and cfg.DATALOADER.DROP_LAST,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
    )
