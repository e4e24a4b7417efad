from .aspp import ASPP
from .build import Dummy, XceptionSeg, build_model, build_train_model, build_xception, init_weights_
from .convert import (
    convert_pth_to_npz,
    flax_to_state_dict,
    load_npz,
    load_torch_checkpoint,
    load_weights,
    save_npz,
    torch_state_dict_to_flax,
)
from .decoder import Decoder
from .deeplab import DeepLabV3Plus, deeplab_from_cfg
from .loss import CrossEntropyLoss, cross_entropy_loss
from .metrics import MeanIOU, confusion_matrix_update, miou_from_confusion
from .layers import BatchNorm2d, ConvBNReLU, DepthwiseConv2d, DepthwiseSeparableConv, same_padding
from .resnet import ResNetBackbone, __all_backbones__, build_backbone
from .xception import Xception65, XceptionBlock

__all__ = [
    "ASPP",
    "Dummy",
    "XceptionSeg",
    "build_model",
    "build_xception",
    "build_train_model",
    "init_weights_",
    "convert_pth_to_npz",
    "flax_to_state_dict",
    "load_npz",
    "load_torch_checkpoint",
    "load_weights",
    "save_npz",
    "torch_state_dict_to_flax",
    "Decoder",
    "DeepLabV3Plus",
    "deeplab_from_cfg",
    "BatchNorm2d",
    "ConvBNReLU",
    "CrossEntropyLoss",
    "cross_entropy_loss",
    "MeanIOU",
    "confusion_matrix_update",
    "miou_from_confusion",
    "DepthwiseConv2d",
    "DepthwiseSeparableConv",
    "same_padding",
    "ResNetBackbone",
    "__all_backbones__",
    "build_backbone",
    "Xception65",
    "XceptionBlock",
]
