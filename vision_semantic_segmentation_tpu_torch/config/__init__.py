from .node import CN, ConfigNode
from .defaults import get_cfg_defaults, resolve_output_dir
from .network import get_train_cfg_defaults, get_demo_cfg_defaults

__all__ = [
    "CN",
    "ConfigNode",
    "get_cfg_defaults",
    "resolve_output_dir",
    "get_train_cfg_defaults",
    "get_demo_cfg_defaults",
]
