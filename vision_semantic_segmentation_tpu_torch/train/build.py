"""Dataloader + transform builders (ref data/build.py:10-104).

Port of ``vision_semantic_segmentation_tpu/train/build.py`` for the
Mapillary dataset.  The BDD and Pascal readers are not ported yet (ROADMAP
queue 1 item 4); asking for them raises.
"""
from __future__ import annotations

from . import transforms as T
from .datasets import DataLoader, MapillaryVistas


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
    if name == "Mapillary":
        dataset = MapillaryVistas(cfg.DATASET.ROOT_DIR, type=mode, transform=transform)
    elif name in ("Pascal", "BDD"):
        raise NotImplementedError(
            f"DATASET.NAME {name!r}: its reader is not ported (ROADMAP queue 1 item 4)")
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
