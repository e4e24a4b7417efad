"""Dataloader + transform builders (ref data/build.py:10-104).

Port of ``vision_semantic_segmentation_tpu/train/build.py``:
``DATASET.NAME`` Mapillary, BDD or Pascal.
"""
from __future__ import annotations

from ..parallel.distributed import rank, world
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


def build_dataloader(cfg, mode: str = "train", distributed: bool = False) -> DataLoader:
    """Mode-driven dataset + loader construction (ref data/build.py:43-104).

    ``distributed=True`` (in a joined process group): the batch size is the
    global batch, of which this rank decodes its contiguous slice (of each
    of ``TRAIN.GRAD_ACCUM_STEPS`` micro-batches in training), a remainder
    batch padded with ignored samples (``DataLoader``'s ``rank``/``world``/
    ``micro``).  The JAX package instead gives each host a strided shard of
    the dataset and a batch of its own.

    With ``TRAIN.SPATIAL_SHARDS`` S > 1 (bands across ranks) the slices are
    the data groups': rank r decodes data group ``r // S``'s, so the S ranks
    of an image decode the same images (the JAX package's per-process shard
    would give one image's bands to processes that loaded different
    images).  Each sample's transforms draw from a generator seeded by
    (``RNG_SEED``, epoch, index) (``DataLoader``'s ``sample_seed``), so
    the S ranks crop and flip an image alike whatever their worker threads'
    order.
    """
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
    bands = max(1, int(getattr(cfg.TRAIN, "SPATIAL_SHARDS", 1))) if distributed else 1
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=is_train,
        drop_last=is_train and cfg.DATALOADER.DROP_LAST,
        num_workers=cfg.DATALOADER.NUM_WORKERS,
        rank=rank() // bands if distributed else 0,
        world=world() // bands if distributed else 1,
        micro=max(1, int(getattr(cfg.TRAIN, "GRAD_ACCUM_STEPS", 1))) if is_train else 1,
        sample_seed=max(0, int(cfg.RNG_SEED)) if bands > 1 else None,
    )
