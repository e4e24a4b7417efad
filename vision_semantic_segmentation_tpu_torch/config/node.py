"""A minimal, dependency-free yacs-compatible configuration node.

The reference builds its whole config surface on ``yacs.config.CfgNode``
(`reference: src/config/base_cfg.py:8`, `.../config/base.py:8`) with the
usage pattern ``cfg.merge_from_file(yaml)``, ``cfg.merge_from_list(opts)``,
``cfg.freeze()`` and ``cfg.clone()``.  We reimplement that small contract
natively so the framework has zero dependency on yacs while remaining
drop-in compatible with the reference's YAML experiment files.

Port copy of ``vision_semantic_segmentation_tpu/config/node.py``: the same
keys and merge rules, so a YAML file means the same thing to both
packages.  PyYAML is imported only where a file or string is parsed, so
the port runs where PyYAML is absent as long as no YAML is read.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List

_VALID_SCALARS = (int, float, bool, str, type(None))


class ConfigNode(dict):
    """A dict subclass with attribute access, freezing and YAML merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        self.__dict__[ConfigNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._coerce(v)

    @classmethod
    def _coerce(cls, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._coerce(v) for v in value)
        return value

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(ConfigNode.IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set {name} on an immutable ConfigNode"
            )
        self[name] = self._coerce(value)

    def __setitem__(self, name: str, value: Any) -> None:
        if self.__dict__.get(ConfigNode.IMMUTABLE, False):
            raise AttributeError(
                f"Attempted to set {name} on an immutable ConfigNode"
            )
        super().__setitem__(name, value)

    # -- immutability -------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        self._set_immutable(True)
        return self

    def defrost(self) -> "ConfigNode":
        self._set_immutable(False)
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[ConfigNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[ConfigNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_immutable(value)

    # -- cloning / merging --------------------------------------------------
    def clone(self) -> "ConfigNode":
        node = copy.deepcopy(self)
        node._set_immutable(False)
        return node

    def merge_from_other_cfg(self, other: "ConfigNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, filename: str) -> None:
        import yaml

        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_into(ConfigNode(loaded), self, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge ``["A.B", v1, "C", v2]`` style override pairs (yacs CLI)."""
        if len(opts) % 2 != 0:
            raise ValueError("Override list must have even length (key value pairs)")
        for key, value in zip(opts[0::2], opts[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            node[leaf] = _check_type(value, node[leaf], key)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=None)

    def __str__(self) -> str:  # mirrors yacs pretty printing closely enough
        return self._fmt(0)

    def _fmt(self, indent: int) -> str:
        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, ConfigNode):
                lines.append(" " * indent + f"{k}:")
                lines.append(v._fmt(indent + 2))
            else:
                lines.append(" " * indent + f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"ConfigNode({super().__repr__()})"

    def __deepcopy__(self, memo):
        node = ConfigNode()
        memo[id(self)] = node
        for k, v in self.items():
            dict.__setitem__(node, k, copy.deepcopy(v, memo))
        node.__dict__[ConfigNode.IMMUTABLE] = False
        return node


def _decode_value(value: str) -> Any:
    """Parse a CLI string override into a python value (yacs semantics)."""
    import yaml

    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def _check_type(new: Any, old: Any, key: str) -> Any:
    if old is None or new is None:
        return new
    if isinstance(old, bool) and not isinstance(new, bool):
        raise ValueError(f"Type mismatch for {key}: expected bool got {type(new)}")
    if isinstance(old, _VALID_SCALARS) and isinstance(new, _VALID_SCALARS):
        if isinstance(old, float) and isinstance(new, int):
            return float(new)
        if type(old) is not type(new) and not (
            isinstance(old, str) and isinstance(new, str)
        ):
            # allow int <-> float promotion only
            if {type(old), type(new)} == {int, float}:
                return new
            raise ValueError(
                f"Type mismatch for {key}: expected {type(old).__name__} "
                f"got {type(new).__name__}"
            )
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return type(old)(new)
    return new


def _merge_into(src: ConfigNode, dst: ConfigNode, path: List[str]) -> None:
    for k, v in src.items():
        full = ".".join(path + [k])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full}")
        if isinstance(v, ConfigNode):
            if not isinstance(dst[k], ConfigNode):
                raise ValueError(f"Cannot merge dict into leaf at {full}")
            _merge_into(v, dst[k], path + [k])
        else:
            dst[k] = _check_type(v, dst[k], full)


# yacs-style short alias used throughout the framework
CN = ConfigNode
