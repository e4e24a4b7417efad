from .aspp import ASPP
from .build import Dummy, build_model, init_weights_
from .convert import flax_to_state_dict
from .decoder import Decoder
from .deeplab import DeepLabV3Plus, deeplab_from_cfg
from .layers import ConvBNReLU, DepthwiseConv2d, DepthwiseSeparableConv, same_padding
from .resnet import ResNetBackbone, __all_backbones__, build_backbone

__all__ = [
    "ASPP",
    "Dummy",
    "build_model",
    "init_weights_",
    "flax_to_state_dict",
    "Decoder",
    "DeepLabV3Plus",
    "deeplab_from_cfg",
    "ConvBNReLU",
    "DepthwiseConv2d",
    "DepthwiseSeparableConv",
    "same_padding",
    "ResNetBackbone",
    "__all_backbones__",
    "build_backbone",
]
