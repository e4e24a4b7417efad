"""The measured program's configuration trees, set from a configuration file.

The file is the source of truth: every size the reference reads is written
into the program's tree here, so both run the configuration as it stands.
"""
from __future__ import annotations


def _network_keys(net: dict) -> list:
    return [
        "MODEL.TYPE", "DeepLabv3+",
        "MODEL.BACKBONE", net["backbone"],
        "MODEL.OUTPUT_STRIDE", net["output_stride"],
        "MODEL.ASPP.OUT_CHANNELS", net["aspp_out_channels"],
        "MODEL.ASPP.ATROUS_CHANNELS", list(net["aspp_atrous_channels"]),
        "MODEL.ASPP.DROPOUT", net["aspp_dropout"],
        "MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS", net["decoder_low_level_out_channels"],
        "MODEL.DECODER.REFINE_CHANNELS", list(net["decoder_refine_channels"]),
        "DATASET.NUM_CLASSES", net["num_classes"],
    ]


def serving_cfg(config: dict):
    """The application tree (``config/defaults.py``) of a serving configuration."""
    from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults

    m = config["map"]
    cfg = get_cfg_defaults()
    cfg.merge_from_list([
        "LABELS", list(m["labels"]), "LABELS_NAMES", list(m["label_names"]),
        "LABEL_COLORS", [list(c) for c in m["label_colors"]],
        "MAPPING.BOUNDARY", [list(b) for b in m["boundary"]],
        "MAPPING.RESOLUTION", m["resolution"],
        "MAPPING.POINT_BUCKET", m["point_bucket"],
        "MAPPING.PCD.RANGE_MAX", m["range_max"],
        "MAPPING.PCD.USE_INTENSITY", m["use_intensity"],
        "VISION_SEM_SEG.IMAGE_SCALE", config["input"]["image_scale"],
    ])
    net = cfg.VISION_SEM_SEG.SEM_SEG_NETWORK
    net.merge_from_list(_network_keys(config["network"]))
    return cfg


def train_cfg(config: dict, root: str, out_dir: str, seed: int):
    """The training tree (``config/network.py``) of a training configuration."""
    from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults

    t = config["train"]
    cfg = get_train_cfg_defaults()
    cfg.merge_from_list(_network_keys(config["network"]) + [
        "MODEL.SYNC_BN", False,
        "DATASET.NAME", "Mapillary", "DATASET.ROOT_DIR", root,
        "DATALOADER.NUM_WORKERS", t["num_workers"], "DATALOADER.DROP_LAST", True,
        "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", t["base_lr"],
        "OPTIMIZER.WEIGHT_DECAY", t["weight_decay"],
        "OPTIMIZER.SGD.momentum", t["momentum"], "OPTIMIZER.SGD.nesterov", False,
        "SCHEDULER.TYPE", "PolyLRDecay", "SCHEDULER.PolyLRDecay.max_iter", t["poly_max_iter"],
        "SCHEDULER.PolyLRDecay.power", t["poly_power"],
        "TRAIN.BATCH_SIZE", t["batch_size"], "TRAIN.COMPUTE_DTYPE", t["compute_dtype"],
        "TRAIN.AUGMENTATION", t["augmentation"], "VALIDATE.PERIOD", 0,
        "OUTPUT_DIR", out_dir, "RNG_SEED", seed,
    ])
    return cfg
